"""Chip smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which must pass (any failure exits non-zero before the
result line):
  1. print the card (``nvidia-smi`` name and power limit) and the versions;
     build both CUDA kernels from ``pytorch_asr_tpu_torch/csrc`` (set-up);
  2. hold each kernel against its plain PyTorch version at the serving
     path's full shapes, and time kernel, plain version and a PyTorch
     library yardstick with CUDA events (median of 20 runs of 10 queued
     calls each, after warm-up);
  3. run the model at float32 on one synthetic batch on the CPU and on the
     card with the same seeded weights; compare logits and greedy tokens;
  4. drive the main path, ``pytorch_asr_tpu_torch.decode.main`` with
     ``ctc_bilstm_dev1h`` at full width in bf16 on 10-16 s utterances, with
     the launch counters set to 0 just before and read just after;
  5. profile one decode batch and print where its device time goes;
  6. print the kernels line, the card line, and ``{"ok": true, ...}`` last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pytorch_asr_tpu_torch import decode
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import FrontendConfig
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.data.synthetic import synthetic_corpus
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.evaluate import build_model, eval_step
from pytorch_asr_tpu_torch.frontend import features
from pytorch_asr_tpu_torch.ops import build, lstm_cuda, stft_cuda

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12          # CUDA cores
PEAK_BF16_S = 989e12         # tensor cores
B, AUDIO = 8, 256000         # 8 utterances of 16 s: the serving batch at its longest
T_LSTM, H = 400, 384         # conv output frames of 16 s; ctc_bilstm_dev1h width
# log-mel: the kernel's fp64 FFT against the plain version's fp32 cuFFT,
# whose own error near log_floor (a band's power a small remainder of large
# terms) is up to ~1e-3 in the log; against a float64 DFT the kernel is held
# to fp32 rounding of its power, mel sum and log (a few 1e-6).
STFT_TOL = 2e-3
STFT_EXACT_TOL = 2e-5
LSTM_TOL = 1e-2              # bf16 output: one bf16 step below 1 (2^-8) + fp32 order
SLICE_TOL = 1e-3             # float32 slice, card vs CPU: FFT, conv and dot orders
DECODE_BATCHES = 4
LAYERS = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back calls
    of ``fn`` between two CUDA events, over ``inner``: the calls queue up, so
    the host's launch cost hides behind the device's work (L2 stays warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, ops_s: float) -> tuple[float, str]:
    """Least time in ms: the larger of bytes over memory rate and operation time."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def exact_log_mel(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The log-mel function in float64: direct DFT of the windowed frames."""
    n_freq = cfg.n_fft // 2 + 1
    T = features.max_frames(audio.shape[1], cfg)
    frames = audio.double().unfold(-1, cfg.win_length, cfg.hop_length)[:, :T]
    n = torch.arange(cfg.win_length, dtype=torch.float64, device=audio.device)
    k = torch.arange(n_freq, dtype=torch.float64, device=audio.device)
    ang = 2 * torch.pi * torch.remainder(n[:, None] * k[None, :], cfg.n_fft) / cfg.n_fft
    win = torch.from_numpy(features.hann_window(cfg.win_length)).double().to(audio.device)
    frames = frames * win
    power = (frames @ torch.cos(ang)).square() + (frames @ torch.sin(ang)).square()
    mel = torch.from_numpy(features.mel_filterbank(cfg)).double().to(audio.device)
    return torch.log(torch.clamp(power @ mel, min=cfg.log_floor)).float()


def stft_phase() -> dict:
    cfg = FrontendConfig()
    rng_audio = np.zeros((B, AUDIO), np.float32)
    for b, (a, _) in enumerate(synthetic_corpus(B, cfg.sample_rate, seed=1,
                                                min_sec=16.0, max_sec=17.0)):
        rng_audio[b, : min(len(a), AUDIO)] = a[:AUDIO]
    audio = torch.from_numpy(rng_audio).cuda()
    got = stft_cuda.stft_log_mel(audio, cfg)
    torch.cuda.synchronize()
    want = stft_cuda.stft_log_mel_plain(audio, cfg)
    err, rel = errors(got, want)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), "stft: bad output")
    check(err <= STFT_TOL, f"stft_log_mel disagrees with its plain version: {err}")
    exact = exact_log_mel(audio, cfg)
    exact_err, _ = errors(got, exact)
    check(exact_err <= STFT_EXACT_TOL, f"stft_log_mel vs a float64 DFT: {exact_err}")
    plain_exact_err, _ = errors(want, exact)

    # Yardstick: torch.stft with the 400-sample window padded to n_fft on the
    # right and the audio padded by n_fft - win, which frames exactly as
    # center=False over win samples; then the same mel product and log.
    n_freq = cfg.n_fft // 2 + 1
    window = torch.zeros(cfg.n_fft, device="cuda")
    window[: cfg.win_length] = torch.hann_window(cfg.win_length, device="cuda")
    mel = torch.from_numpy(features.mel_filterbank(cfg)).cuda()
    padded = torch.nn.functional.pad(audio, (0, cfg.n_fft - cfg.win_length))

    def library():
        spec = torch.stft(padded, cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                          center=False, return_complex=True)
        return torch.log(torch.clamp(spec.abs().square().transpose(1, 2) @ mel,
                                     min=cfg.log_floor))

    lib_err, _ = errors(library(), want)
    check(lib_err <= STFT_TOL, f"stft yardstick computes another function: {lib_err}")
    # What the function needs a frame: the window product, a real FFT of
    # n_fft points (2.5 n log2 n), the power, the mel product over the bank's
    # nonzeros (it is sparse: triangles), and the log.
    T = features.max_frames(AUDIO, cfg)
    nnz = int((mel != 0).sum())
    ops = B * T * (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_freq
                   + cfg.n_mels) + B * T * 2 * nnz
    nbytes = 4 * (B * AUDIO + B * T * cfg.n_mels + cfg.win_length + n_freq * cfg.n_mels)
    b_ms, b_by = bound(nbytes, ops / PEAK_FP32_S)
    return {"name": "stft_log_mel", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/stft_log_mel.cu",
            "replaces": "pytorch_asr_tpu/ops/stft_pallas.py:189",
            "shape": f"audio ({B}, {AUDIO}) f32 -> ({B}, {T}, {cfg.n_mels}) f32",
            "max_abs_err": err, "max_rel_err": rel, "tol": STFT_TOL,
            "max_abs_err_vs_fp64": exact_err, "tol_vs_fp64": STFT_EXACT_TOL,
            "plain_max_abs_err_vs_fp64": plain_exact_err,
            "ms": time_ms(lambda: stft_cuda.stft_log_mel(audio, cfg)),
            "plain_ms": time_ms(lambda: stft_cuda.stft_log_mel_plain(audio, cfg)),
            "library_ms": time_ms(library), "library": "torch.stft + mel matmul + log",
            "bound_ms": b_ms, "bound_by": b_by}


def lstm_phase() -> dict:
    g = torch.Generator().manual_seed(2)
    lengths = torch.tensor([T_LSTM, 371, 352, 330, 310, 290, 260, 250], dtype=torch.int32)
    cases = []
    for D in (2 * H, 640):        # layers 1-2, then layer 0 (20 freq x 32 channels)
        x = (torch.randn(B, T_LSTM, D, generator=g) * 0.5).bfloat16().cuda()
        wih = (torch.randn(D, 4 * H, generator=g) / D ** 0.5).bfloat16().cuda()
        whh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).cuda()
        bias = (torch.randn(4 * H, generator=g) * 0.1).cuda()
        lens = lengths.cuda()
        for reverse in (False, True):
            args = (x, wih, whh, bias, lens, reverse, torch.bfloat16)
            got = lstm_cuda.lstm_seq(*args)
            torch.cuda.synchronize()
            want = lstm_cuda.lstm_seq_plain(*args)
            err, rel = errors(got, want)
            check(bool(torch.isfinite(got.float()).all()), "lstm_seq: non-finite output")
            check(err <= LSTM_TOL, f"lstm_seq D={D} reverse={reverse} disagrees: {err}")
            case = {"D": D, "reverse": reverse, "max_abs_err": err, "max_rel_err": rel,
                    "ms": time_ms(lambda: lstm_cuda.lstm_seq(*args)),
                    "plain_ms": time_ms(lambda: lstm_cuda.lstm_seq_plain(*args), reps=5, inner=1,
                                        warmup=1)}
            # Yardstick: cuDNN's fp32 LSTM, same weights, every length = T.
            ref = torch.nn.LSTM(D, H, batch_first=True).cuda()
            with torch.no_grad():
                ref.weight_ih_l0.copy_(wih.float().T)
                ref.weight_hh_l0.copy_(whh.T)
                ref.bias_ih_l0.copy_(bias)
                ref.bias_hh_l0.zero_()
            xf = x.float()
            with torch.no_grad():
                case["library_ms"] = time_ms(lambda: ref(xf))
            valid = int(lengths.sum())
            ops_bf16 = 2 * D * 4 * H * valid
            ops_f32 = 2 * H * 4 * H * valid
            nbytes = (2 * B * T_LSTM * D + 2 * D * 4 * H + 4 * H * 4 * H + 4 * 4 * H
                      + 4 * B + 2 * B * T_LSTM * H)
            case["bound_ms"], case["bound_by"] = bound(
                nbytes, ops_bf16 / PEAK_BF16_S + ops_f32 / PEAK_FP32_S)
            cases.append(case)
    head = cases[0]
    return {"name": "lstm_seq", "route": "cuda",
            "source": "pytorch_asr_tpu_torch/csrc/lstm_seq.cu",
            "replaces": "pytorch_asr_tpu/ops/lstm_pallas.py:280",
            "shape": f"x ({B}, {T_LSTM}, {2 * H}) bf16, H {H}, lengths {lengths.tolist()}",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases), "tol": LSTM_TOL,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
            "library": "torch.nn.LSTM (cuDNN, fp32, all lengths = T)",
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "cases": cases}


def slice_phase() -> dict:
    """Full width, float32 compute, one short synthetic batch: card vs CPU."""
    cfg = get_config("ctc_bilstm_dev1h", **{"model.compute_dtype": "float32",
                                            "data.synthetic_num_utts": "8",
                                            "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device)
        with torch.inference_mode():
            out = model(torch.from_numpy(batch["audio"]).to(device),
                        torch.from_numpy(batch["audio_len"]).to(device))
        outs[device] = {k: v.cpu() for k, v in out.items()}
    cpu, gpu = outs["cpu"], outs["cuda"]
    check(torch.equal(cpu["enc_len"], gpu["enc_len"]), "slice: enc_len differs")
    check(bool(torch.isfinite(gpu["ctc_logits"]).all()), "slice: non-finite logits")
    err, _ = errors(gpu["ctc_logits"], cpu["ctc_logits"])
    check(err <= SLICE_TOL, f"slice logits card vs CPU: {err}")
    top2 = cpu["ctc_logits"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_TOL
    same = gpu["ctc_logits"].argmax(-1)[clear] == cpu["ctc_logits"].argmax(-1)[clear]
    check(bool(same.all()), "slice: greedy tokens differ where the top-2 gap is clear")
    ids_c, n_c = greedy_ctc(cpu["ctc_logits"], cpu["enc_len"])
    ids_g, n_g = greedy_ctc(gpu["ctc_logits"], gpu["enc_len"])
    return {"logits_max_abs_err": err, "tol": SLICE_TOL,
            "clear_frames": float(clear.float().mean()),
            "tokens_equal": bool(torch.equal(ids_c, ids_g) and torch.equal(n_c, n_g)),
            "shape": list(gpu["ctc_logits"].shape)}


def decode_phase() -> dict:
    # One bucket and 8 utterances a batch: every batch the path decodes is full.
    argv = ["ctc_bilstm_dev1h", "data.synthetic_min_sec=10", "data.synthetic_max_sec=16",
            f"data.synthetic_num_utts={DECODE_BATCHES * B}", "data.auto_buckets=1",
            f"max_batches={DECODE_BATCHES}"]
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    result = decode.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(set(result) == {"wer", "cer", "num_utts", "decode_rtf"}, f"decode: {result}")
    check(result["num_utts"] == DECODE_BATCHES * B and 0.0 <= result["wer"]
          and result["decode_rtf"] > 0, f"decode: bad result {result}")
    check(launches["stft_log_mel"] == DECODE_BATCHES,
          f"stft launches {launches['stft_log_mel']} != {DECODE_BATCHES} batches")
    check(launches["lstm_seq"] == DECODE_BATCHES * LAYERS * 2,
          f"lstm launches {launches['lstm_seq']} != {DECODE_BATCHES} x {LAYERS} x 2")
    return {**result, "wall_s": wall, "batches": DECODE_BATCHES, "launches": launches}


def profile_phase() -> list:
    """Device time by kernel name over one bf16 decode batch of 10-16 s utterances."""
    cfg = get_config("ctc_bilstm_dev1h", **{"data.synthetic_min_sec": "10",
                                            "data.synthetic_max_sec": "16",
                                            "data.synthetic_num_utts": "8",
                                            "data.auto_buckets": "1"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = build_model(cfg, "cuda")
    with torch.inference_mode():
        eval_step(model, batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ids, _ = eval_step(model, batch)
            ids.cpu()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": ev.key[:60], "device_ms": dev_us / 1e3, "calls": ev.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:8]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build(["stft_log_mel", "lstm_seq"])
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = [stft_phase(), lstm_phase()]
    for k in kernels:
        print(f"check {k['name']}: max_abs_err {k['max_abs_err']:.3g} "
              f"(tol {k['tol']}) ms {k['ms']:.4f} plain {k['plain_ms']:.4f} "
              f"library {k['library_ms']:.4f} bound {k['bound_ms']:.4f} ({k['bound_by']})")
    print("slice:", json.dumps(slice_phase()))
    dec = decode_phase()
    print("decode:", json.dumps(dec))
    for k in kernels:
        k["launches"] = dec["launches"][k["name"]]
        k["kernel_ms"] = k["ms"]
    print("profile:", json.dumps(profile_phase()))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
