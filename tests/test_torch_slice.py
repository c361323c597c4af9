"""The port's greedy-CTC slice vs the JAX package on the CPU, at a small size.

The JAX ``ASRModel`` (float32 compute) runs once on plain XLA and once with
its Pallas kernels in interpret mode; the port loads the same parameters
through ``weights.load_jax_params``.  Audio is made with numpy from a seed.
The layout traps of the conv -> LSTM seam each have a named test.
"""

from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.decoding.greedy import greedy_ctc as jax_greedy_ctc
from pytorch_asr_tpu.models.asr_model import ASRModel as JaxASRModel
from pytorch_asr_tpu.models.encoder_bilstm import ConvSubsampler as JaxConvSubsampler
from pytorch_asr_tpu.ops import runtime as jax_runtime
from pytorch_asr_tpu_torch import decode, evaluate, runtime, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.encoder_bilstm import ConvSubsampler, LSTMDirection
from pytorch_asr_tpu_torch.ops import lstm_cuda

SMALL = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
         "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
         "model.compute_dtype": "float32"}
# Float32 on both sides; the frontends' FFTs and the stacks' dot products
# sum in other orders (about 1e-6 relative; 2e-7 measured on these logits).
XLA_TOL = 1e-5
# The Pallas STFT kernel's bf16x3 products move log-mel by up to 2e-3
# (tests/test_stft_pallas.py); CMVN and the small random-weight stack
# shrink that to about 2e-6 on these logits.
PALLAS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(seed=0, B=3, A=16000):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, A)).astype(np.float32) * 0.3
    lens = np.array([A, A * 3 // 4, A // 2 + 321], np.int32)[:B]
    for b, n in enumerate(lens):
        audio[b, n:] = 0.0
    return audio, lens


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("ctc_bilstm_dev1h", **SMALL)
    audio, lens = _audio()
    jmodel = JaxASRModel(jcfg.frontend, jcfg.model, 31)
    params = jmodel.init(jax.random.key(0), jnp.asarray(audio), jnp.asarray(lens),
                         train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = get_config("ctc_bilstm_dev1h", **SMALL)
    model = evaluate.build_model(cfg, "cpu", weights.load_jax_params(params))
    return jmodel, params, model, cfg


def _jax_out(jmodel, params, audio, lens, interpret):
    jax_runtime.force_interpret(True if interpret else None)
    try:
        out = jmodel.apply({"params": params}, jnp.asarray(audio), jnp.asarray(lens),
                           train=False)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jax_runtime.force_interpret(None)


def _port_out(model, audio, lens):
    with torch.inference_mode():
        out = model(torch.from_numpy(audio), torch.from_numpy(lens))
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
            for k, v in out.items()}


def _check_greedy(ours_logits, ref_logits, enc_len, tol):
    """Greedy ids agree at every frame whose top-2 logit gap exceeds the tolerance."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(ours_logits.argmax(-1)[clear], ref_logits.argmax(-1)[clear])
    assert clear.mean() > 0.5
    if clear.all():
        ids, n = greedy_ctc(torch.from_numpy(ours_logits), torch.from_numpy(enc_len))
        jids, jn = jax_greedy_ctc(jnp.asarray(ref_logits), jnp.asarray(enc_len))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_slice_matches_jax(models, interpret):
    jmodel, params, model, _ = models
    audio, lens = _audio()
    ref = _jax_out(jmodel, params, audio, lens, interpret)
    ours = _port_out(model, audio, lens)
    tol = PALLAS_TOL if interpret else XLA_TOL
    np.testing.assert_array_equal(ours["enc_len"], ref["enc_len"])
    assert ours["ctc_logits"].shape == ref["ctc_logits"].shape
    np.testing.assert_allclose(ours["ctc_logits"], ref["ctc_logits"], rtol=tol, atol=tol)
    _check_greedy(ours["ctc_logits"], ref["ctc_logits"], ours["enc_len"], tol)


def test_greedy_ctc_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 30, 7)).astype(np.float32)
    logits[:, :, 0] += 0.8                      # plenty of blanks and repeats
    lens = np.array([30, 17, 1, 0], np.int32)
    ids, n = greedy_ctc(torch.from_numpy(logits), torch.from_numpy(lens))
    jids, jn = jax_greedy_ctc(jnp.asarray(logits), jnp.asarray(lens))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def _conv_pair(models):
    jmodel, params, model, cfg = models
    jconv = JaxConvSubsampler(jax_get_config("ctc_bilstm_dev1h", **SMALL).model.encoder,
                              jnp.float32)
    jparams = params["encoder"]["ConvSubsampler_0"]
    return jconv, jparams, model.encoder.conv


def test_layout_conv_feature_order_into_lstm0(models):
    """NCHW conv output is permuted to (B, T, F, C) before the reshape, so the
    features reach lstm0 as f*C + c, the order of JAX's NHWC reshape."""
    jconv, jparams, conv = _conv_pair(models)
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 21, 80)).astype(np.float32)
    lens = np.array([21, 21], np.int32)
    ref, _ = jconv.apply({"params": jparams}, jnp.asarray(feats), jnp.asarray(lens))
    ours, _ = conv(torch.from_numpy(feats), torch.from_numpy(lens))
    assert conv.convs[-1].out_channels > 1 and ours.shape[-1] > conv.convs[-1].out_channels
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_layout_conv_padding_and_remask(models):
    """Fixed symmetric padding and a re-mask after every conv: lengths follow
    conv_out_len, frames past them are zero, and extra batch padding leaves
    the valid frames unchanged."""
    jconv, jparams, conv = _conv_pair(models)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 37, 80)).astype(np.float32)
    lens = np.array([37, 19], np.int32)
    feats[1, 19:] = 0.0
    ref, ref_len = jconv.apply({"params": jparams}, jnp.asarray(feats), jnp.asarray(lens))
    ours, n = conv(torch.from_numpy(feats), torch.from_numpy(lens))
    ours = ours.detach().numpy()
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not ours[1, int(n[1]):].any()
    padded = np.concatenate([feats, np.zeros((2, 11, 80), np.float32)], axis=1)
    more, n2 = conv(torch.from_numpy(padded), torch.from_numpy(lens))
    np.testing.assert_array_equal(n2.numpy(), n.numpy())
    np.testing.assert_allclose(more.detach().numpy()[:, : ours.shape[1]], ours,
                               rtol=1e-6, atol=1e-6)


def test_layout_lstm_dtypes(monkeypatch):
    """x and wih reach the kernel in the compute dtype, whh and bias in fp32,
    lengths in int32, training residuals in bf16 (the JAX default); the
    output comes back in the compute dtype."""
    seen = {}

    def spy(x, wih, whh, bias, lengths, reverse, out_dtype, residual_dtype):
        seen.update(x=x.dtype, wih=wih.dtype, whh=whh.dtype, bias=bias.dtype,
                    lengths=lengths.dtype, out=out_dtype, residuals=residual_dtype)
        return lstm_cuda.lstm_seq_plain(x, wih, whh, bias, lengths, reverse, out_dtype)

    monkeypatch.setattr(lstm_cuda, "lstm_seq", spy)
    d = LSTMDirection(6, 4, reverse=True, dtype=torch.bfloat16)
    for p in d.parameters():
        torch.nn.init.normal_(p, generator=torch.Generator().manual_seed(0))
    out = d(torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(1)),
            torch.tensor([5, 3]))
    assert seen == dict(x=torch.bfloat16, wih=torch.bfloat16, whh=torch.float32,
                        bias=torch.float32, lengths=torch.int32, out=torch.bfloat16,
                        residuals=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and not out[1, 3:].any()


def test_layout_reverse_direction_shares_window():
    """The reverse direction walks [0, len) backwards with no flip of the
    padded tensor: it equals the forward direction over the flipped valid
    prefix, flipped back, and is zero past len."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    wih, whh = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
                for s in ((5, 12), (3, 12)))
    bias = torch.zeros(12)
    lengths = torch.tensor([9, 6], dtype=torch.int32)
    rev = lstm_cuda.lstm_seq_plain(x, wih, whh, bias, lengths, reverse=True)
    for b, n in enumerate(lengths.tolist()):
        fwd = lstm_cuda.lstm_seq_plain(x[b:b + 1, :n].flip(1), wih, whh, bias,
                                       torch.tensor([n], dtype=torch.int32))
        torch.testing.assert_close(rev[b, :n], fwd[0].flip(0), rtol=1e-6, atol=1e-6)
        assert not rev[b, n:].any()


def test_layout_tf32_switches_off_where_model_starts():
    torch.backends.cudnn.allow_tf32 = True
    evaluate.build_model(get_config("ctc_bilstm_dev1h", **SMALL), "cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cuda_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_init_weights_are_seeded_and_device_independent():
    cfg = get_config("ctc_bilstm_dev1h", **SMALL)
    a = ASRModel(cfg.frontend, cfg.model, 31, seed=3).state_dict()
    b = ASRModel(cfg.frontend, cfg.model, 31, seed=3).state_dict()
    c = ASRModel(cfg.frontend, cfg.model, 31, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layers.0.fwd.wih"], c["encoder.layers.0.fwd.wih"])
    assert torch.equal(a["encoder.layers.1.bwd.bias"][16:32], torch.ones(16))


def test_load_jax_params_rejects_unknown_keys(models):
    _, params, _, _ = models
    with pytest.raises(KeyError, match="las"):
        weights.load_jax_params({**params, "las": {"w": np.zeros(2)}})


def test_decode_main_with_npz_params(models, tmp_path, capsys):
    """``params=<file.npz>`` (keys are '/'-joined JAX paths) gives the same
    logits as loading the tree directly, and main prints the result dict."""
    _, params, model, _ = models
    path = tmp_path / "params.npz"
    np.savez(path, **weights.flatten(params))
    loaded = weights.load_npz(str(path))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    argv = ["ctc_bilstm_dev1h", *(f"{k}={v}" for k, v in SMALL.items()), "device=cpu",
            f"params={path}", "max_batches=1", "data.synthetic_num_utts=8", "data.auto_buckets=1",
            "data.batch_size=4"]
    result = decode.main(argv)
    assert set(result) == {"wer", "cer", "num_utts", "decode_rtf", "world_size", "dist_backend"}
    assert result["world_size"] == 1 and result["dist_backend"] is None
    assert result["num_utts"] == 4 and 0.0 <= result["cer"]
    assert str(result) in capsys.readouterr().out


def test_decode_cli_on_cpu():
    cmd = [sys.executable, "-m", "pytorch_asr_tpu_torch.decode", "ctc_bilstm_dev1h",
           *(f"{k}={v}" for k, v in SMALL.items()), "device=cpu", "max_batches=1",
           "data.synthetic_num_utts=6", "data.auto_buckets=1", "data.batch_size=3", "model.compute_dtype=bfloat16"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert set(result) == {"wer", "cer", "num_utts", "decode_rtf", "world_size", "dist_backend"}
    assert result["num_utts"] == 3 and result["decode_rtf"] > 0
