"""Times the prefix beam search's designs on one device: the port of the JAX
package's ``scripts/bench_prefix_beam.py``, with its arms and defaults.

    python -m pytorch_asr_tpu_torch.scripts.bench_prefix_beam [B=16 T=1000 K=16 V=32
        iters=5 lm=1 hashed=1 fused=0 lanes=1 ext_top_a= lm_top_k=128 n_ctx=1024
        rnn_layers=2 device=cuda]

Random logits (numpy seed 0) of B utterances of T frames over V chars, beam
K.  Each arm is timed over ``iters`` calls after a warm-up, the device
synchronised around each call, and prints its milliseconds a call,
microseconds a frame and the real-time factor at 100 frames a second:
  * ``plain scan``: the port's plain search (the JAX script's "xla scan");
  * with ``lm=1``: the plain search with a dense table of log-probs
    (n_ctx = min(V^2, 4096)); with ``hashed=1`` the search (K7/K8's hashed
    form on the card) with the JAX script's synthetic hashed 3-gram (8 V
    bigrams, 32 V trigrams, 8 V bigram backoffs, a dense bigram level where
    V^2 fits), over all chars (``hashed LM``) and, with V >= 256, with
    ``lm_top_k`` = A (``hashed A=``) and over each frame's top A chars
    (``hashed ext_top_a=``, and the same without an LM); then the plain
    search with a char RNN LM (E 64, H 256, 1 layer, random weights);
  * ``fused=1``: the search with each beam's tokens in the kernel (K13);
  * ``lanes=1`` with K V <= 2048: K7 without and with the table and, with
    ``lm=1``, K9 over all chars; with V >= 256, K8 over the top A =
    ``ext_top_a`` (or ``lm_top_k``) chars and, with ``lm=1``, the plain and
    kernel searches with a table of n_ctx rows and with a char RNN LM (E
    128, H 256, ``rnn_layers`` layers) over the top A;
  * last, the plain candidates, merge and top-K alone, frame by frame.
Runs on the GPU unless ``device=cpu``, where every search is the plain one.
Returns {arm: {"ms", "us_per_frame", "rtf"}} and the device.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.decoding.lm_hashed import HashedNgramLM, _build_table
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda
from pytorch_asr_tpu_torch.scripts import _timing

DEFAULTS = {"B": "16", "T": "1000", "K": "16", "V": "32", "iters": "5", "lm": "1",
            "hashed": "1", "fused": "0", "lanes": "1", "ext_top_a": "", "lm_top_k": "128",
            "n_ctx": "1024", "rnn_layers": "2"}


def _table(rng, n_ctx: int, V: int, device) -> torch.Tensor:
    """(n_ctx, V) rows of log-probs drawn from a flat Dirichlet."""
    return torch.from_numpy(np.log(rng.dirichlet(np.ones(V), size=n_ctx)).astype(np.float32)
                            ).to(device)


def synthetic_hashed_lm(rng, V: int, device) -> HashedNgramLM:
    """The JAX script's synthetic hashed 3-gram, drawn from ``rng`` in its
    order: 8 V bigrams, a dense bigram level (NaN where absent), a unigram
    row from a flat Dirichlet, 32 V trigrams and 8 V bigram backoffs, values
    standard normal."""
    def synth_entries(n_entries, order):
        grams = rng.integers(1, V, size=(n_entries, order))
        return {tuple(map(int, g)): float(rng.standard_normal()) for g in grams}

    bigrams = synth_entries(8 * V, 2)
    bi = np.full((V, V), np.nan, np.float32)
    for (w, c), lp in bigrams.items():
        bi[w, c] = lp
    uni = torch.from_numpy(np.log(rng.dirichlet(np.ones(V))).astype(np.float32))
    probs = (_build_table(bigrams, device), _build_table(synth_entries(32 * V, 3), device))
    return HashedNgramLM(uni=uni.to(device), uni_backoff=torch.zeros(V, device=device),
                         probs=probs, backoffs=(_build_table(synth_entries(8 * V, 2), device),),
                         bi_dense=torch.from_numpy(bi).to(device))


def main(argv: list[str] | None = None) -> dict:
    kv, device = _timing.parse(sys.argv[1:] if argv is None else argv, DEFAULTS)
    B, T, K, V, iters = (int(kv[k]) for k in ("B", "T", "K", "V", "iters"))
    lm, fused, lanes = kv["lm"] == "1", kv["fused"] == "1", kv["lanes"] == "1"
    print(f"device: {_timing.device_name(device)} B={B} T={T} K={K} V={V}")
    rng, logits, lens = _timing.random_logits(B, T, V, device)
    audio_s = B * T / 100.0
    results = {}

    def measure(name, fn):
        dt = _timing.seconds_per_call(fn, iters, device)
        results[name.strip()] = {"ms": dt * 1e3, "us_per_frame": dt / T * 1e6,
                                 "rtf": dt / audio_s}
        print(f"{name}: {dt*1e3:.2f} ms  per-step {dt/T*1e6:.1f} us  RTF {dt/audio_s:.6f}  "
              f"(batch RTF over {audio_s:.0f} audio-s)")

    measure("plain scan", lambda: pb.prefix_beam_search_plain(logits, lens, beam_size=K))
    if lm:
        table = _table(rng, min(V * V, 4096), V, device)
        measure("dense LM  ", lambda: pb.prefix_beam_search_plain(
            logits, lens, beam_size=K, lm_table=table, lm_alpha=0.5, lm_beta=1.0))
        hl = synthetic_hashed_lm(rng, V, device)
        if kv["hashed"] == "1":
            measure("hashed LM ", lambda: pb.prefix_beam_search(
                logits, lens, beam_size=K, hash_lm=hl, lm_alpha=0.5, lm_beta=1.0))
        if V >= 256 and kv["hashed"] == "1":
            A = int(kv["lm_top_k"])
            measure(f"hashed A={A}", lambda: pb.prefix_beam_search(
                logits, lens, beam_size=K, hash_lm=hl, lm_alpha=0.5, lm_beta=1.0, lm_top_k=A))
            measure(f"hashed ext_top_a={A}", lambda: pb.prefix_beam_search(
                logits, lens, beam_size=K, hash_lm=hl, lm_alpha=0.5, lm_beta=1.0,
                ext_top_a=A))
            measure(f"no-LM ext_top_a={A}", lambda: pb.prefix_beam_search(
                logits, lens, beam_size=K, ext_top_a=A))
        rnn = CharRNNLM(RNNLMConfig(embed_dim=64, hidden_dim=256, num_layers=1), V,
                        seed=0).to(device)
        measure("rnn LM    ", lambda: pb.prefix_beam_search_plain(
            logits, lens, beam_size=K, rnn_lm=rnn, lm_alpha=0.5, lm_beta=1.0, sos_id=V - 1))
    if fused:
        measure("fused beam", lambda: beam_cuda.prefix_beam_fused(logits, lens, beam_size=K))
    if lanes and V * K <= 2048:
        measure("lanes beam", lambda: pb.prefix_beam_search(logits, lens, K, 0, max_len=256))
        table_l = _table(rng, min(V * V, 4096), V, device)
        measure("lanes+dense", lambda: pb.prefix_beam_search(
            logits, lens, K, 0, table_l, 0.5, 1.0, max_len=256))
        if lm:
            rnn_f = CharRNNLM(RNNLMConfig(embed_dim=64, hidden_dim=256, num_layers=1), V,
                              seed=0).to(device)
            measure("lanes rnn full-vocab", lambda: pb.prefix_beam_search(
                logits, lens, K, 0, max_len=256, rnn_lm=rnn_f, lm_alpha=0.5, lm_beta=1.0,
                sos_id=V - 1))
    elif lanes and V >= 256:
        A = int(kv["ext_top_a"] or kv["lm_top_k"])
        measure(f"lanes topA={A}", lambda: pb.prefix_beam_search(
            logits, lens, K, 0, max_len=256, ext_top_a=A))
        if lm:
            n_ctx = int(kv["n_ctx"])
            table_t = _table(rng, n_ctx, V, device)
            measure(f"scan dense topA={A}", lambda: pb.prefix_beam_search_plain(
                logits, lens, beam_size=K, lm_table=table_t, lm_alpha=0.5, lm_beta=1.0,
                ext_top_a=A))
            measure(f"lanes dense topA={A} n_ctx={n_ctx}", lambda: pb.prefix_beam_search(
                logits, lens, K, 0, table_t, 0.5, 1.0, max_len=256, ext_top_a=A))
            nl = int(kv["rnn_layers"])
            rnn_t = CharRNNLM(RNNLMConfig(embed_dim=128, hidden_dim=256, num_layers=nl), V,
                              seed=0).to(device)
            measure(f"scan rnn topA={A}", lambda: pb.prefix_beam_search_plain(
                logits, lens, beam_size=K, rnn_lm=rnn_t, lm_alpha=0.5, lm_beta=1.0,
                sos_id=V - 1, ext_top_a=A))
            measure(f"lanes rnn topA={A} H=256 nl={nl}", lambda: pb.prefix_beam_search(
                logits, lens, K, 0, max_len=256, ext_top_a=A, rnn_lm=rnn_t, lm_alpha=0.5,
                lm_beta=1.0, sos_id=V - 1))

    logp = torch.log_softmax(logits, dim=-1)

    def merge_only():
        state = pb._init_state(B, K, 256, device)
        for t in range(T):
            stay, ext = pb._build_candidates(state, logp[:, t], blank=0, vocab=V,
                                             lm_table=None, lm_rows=None, lm_alpha=0.0,
                                             lm_beta=0.0, K=K, L=256)
            _, f = pb._merge_topk(stay, ext, K)
            state = state._replace(pb=f["pb"], pnb=f["pnb"], lm_s=f["lm"], hash=f["hash"],
                                   ctx=f["ctx"], last=f["last"])
        return state.pb

    dm = _timing.seconds_per_call(merge_only, iters, device)
    results["cand+merge+topk scan"] = {"ms": dm * 1e3, "us_per_frame": dm / T * 1e6}
    print(f"cand+merge+topk scan (no token rebuild): {dm*1e3:.2f} ms  "
          f"per-step {dm/T*1e6:.1f} us")
    return {"device": _timing.device_name(device), "B": B, "T": T,
            "calls_per_arm": iters + 1, "arms": results}


if __name__ == "__main__":
    main()
