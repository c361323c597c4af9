"""Holds K9's co-resident grid, the float32 plain search and a float64 plain
search against one another on the card tests' inputs, where the two float32
searches could part on a near-tie.

    python -m pytorch_asr_tpu_torch.scripts.rnn_grid_witness [device=cuda]

The inputs are those of ``tests/test_torch_kernels_cuda.py::
test_prefix_beam_rnn_grid_matches_plain``: numpy seed 21, B 1, 16 or 33
rows of 40 frames over 31 chars with a random path planted at ``gain`` (4
or 8), the last row of a batch cut to no frames; beam 8, over all chars or
the top 8, max_len 24 or 48; the test's LM (E 16, H 32, 1-3 layers, torch
seed 11, its weights scaled up and biases drawn).  The float64 search is
the same plain search with the float32 log-probs, the LM's weights and
every sum in float64.  For each case it prints one JSON line: the rows
where the grid's tokens and lengths differ from the float32 search's, from
the float64 search's, and where the two plain searches differ.  For each
row where the grid differs from the float64 search it also gives how near
that row's selections came to a tie: the float64 search's margin at each
frame between the K-th candidate kept and the first one cut (the five
smallest, with their frames), and how many of 16 float32 plain searches
with every LM weight moved by at most one ulp (a factor 1 + u 2^-23, u in
{-1, 0, 1}, from torch seeds 0-15) give the grid's tokens.  Then a summary
line.  Needs the card: the grid runs only there.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import sys

import numpy as np
import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.models.lm_rnn import CharRNNLM, LMState, RNNLMConfig
from pytorch_asr_tpu_torch.ops import beam_cuda, build
from pytorch_asr_tpu_torch.scripts import _timing

V, T, K, SOS, ALPHA, BETA = 31, 40, 8, 29, 0.5, 1.0


def case_inputs(B: int, gain: float, device):
    """The card test's logits (B, T, V) and lengths (B,)."""
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    path = rng.integers(0, V, size=(B, T))
    for b in range(B):
        logits[b, np.arange(T), path[b]] += gain
    lens = np.array(([T, T - 13, 0, T // 3] * -(-B // 4))[:B], np.int32)
    if B > 1:
        lens[-1] = 0
    return torch.from_numpy(logits).to(device), torch.from_numpy(lens).to(device)


def case_lm(nl: int, device) -> CharRNNLM:
    """The card test's LM: the drawn weights scaled up and random biases."""
    lm = CharRNNLM(RNNLMConfig(embed_dim=16, hidden_dim=32, num_layers=nl), V, seed=11)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in lm.parameters():
            p.mul_(3.0).add_(0.3 * torch.randn(p.shape, generator=g))
    return lm.to(device).requires_grad_(False)


def _step64(model: CharRNNLM, y_prev, state):
    logits, new_state = model.step(y_prev, state)
    return torch.log_softmax(logits, dim=-1), new_state


@contextlib.contextmanager
def _lm_in_float64():
    """The plain search's LM step without its cast of the logits to float32."""
    saved = pb.lm_step_logp
    pb.lm_step_logp = _step64
    try:
        yield
    finally:
        pb.lm_step_logp = saved


def plain64(logits, lens, A: int, L: int, lm: CharRNNLM):
    """The plain search in float64 on the float32 log-probs and top-A."""
    logp, (tv, ti) = pb._prepare(logits, A)
    lm64 = copy.deepcopy(lm).double()
    nl, H = lm.cfg.num_layers, lm.cfg.hidden_dim
    zeros = torch.zeros((nl, 1, H), dtype=torch.float64, device=logits.device)
    with torch.no_grad(), _lm_in_float64():
        lmp0, st = _step64(lm64, torch.full((1,), SOS, device=logits.device),
                           LMState(zeros, zeros.clone()))
        return pb.beam_scan_plain(logp.double(), lens, K, L, None, ALPHA, BETA,
                                  tv.double() if tv is not None else None, ti, rnn_lm=lm64,
                                  lm_state=(st.h[:, 0], st.c[:, 0], lmp0[0]))


@contextlib.contextmanager
def margins_recorded():
    """Records, at each frame of the plain search, the score of the K-th
    candidate kept less that of the first one cut ((B,) per frame)."""
    saved, margins = pb._merge_topk, []

    def merge(stay, ext, K_, sparse=False):
        score, fields = saved(stay, ext, K_ + 1, sparse)
        margins.append(torch.where(score[:, K_] > pb.NEG_INF / 2,
                                   score[:, K_ - 1] - score[:, K_], float("inf")))
        return score[:, :K_], {k: v[:, :K_] for k, v in fields.items()}

    pb._merge_topk = merge
    try:
        yield margins
    finally:
        pb._merge_topk = saved


def near_tie(logits, lens, A: int, L: int, lm: CharRNNLM, grid) -> dict:
    """For one row (B 1): the float64 search's five smallest selection
    margins over the row's frames, and how many of 16 one-ulp moves of the
    LM's weights make the float32 plain search give the grid's tokens."""
    with margins_recorded() as margins:
        plain64(logits, lens, A, L, lm)
    m = torch.stack(margins)[: int(lens[0]), 0].cpu()
    small = torch.argsort(m)[:5].tolist()
    hits = []
    for seed in range(16):
        moved = copy.deepcopy(lm)
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in moved.parameters():
                u = torch.randint(-1, 2, p.shape, generator=g).to(p.device, p.dtype)
                p.mul_(1.0 + u * 2.0 ** -23)
        got = pb.prefix_beam_search_plain(logits, lens, beam_size=K, max_len=L, ext_top_a=A,
                                          rnn_lm=moved, sos_id=SOS, lm_alpha=ALPHA,
                                          lm_beta=BETA)
        hits.append(not rows_differing(got, grid))
    return {"f64_smallest_margins": [[t, m[t].item()] for t in small],
            "one_ulp_moves_giving_the_grids_tokens": sum(hits), "of": len(hits)}


def rows_differing(a, b) -> list[int]:
    same = (a[0] == b[0]).all(1) & (a[1] == b[1])
    return [int(i) for i in torch.nonzero(~same).flatten().tolist()]


def main(argv: list[str] | None = None) -> dict:
    _, device = _timing.parse(sys.argv[1:] if argv is None else argv, {})
    if device.type != "cuda":
        raise RuntimeError("rnn_grid_witness: the grid runs only on the card")
    print(f"device: {_timing.device_name(device)}")
    totals: dict[str, dict[str, int]] = {}
    for gain, L, B, A, nl in itertools.product((4.0, 8.0), (24, 48), (1, 16, 33), (0, 8),
                                               (1, 2, 3)):
        logits, lens = case_inputs(B, gain, device)
        lm = case_lm(nl, device)
        kw = dict(beam_size=K, max_len=L, ext_top_a=A, rnn_lm=lm, sos_id=SOS, lm_alpha=ALPHA,
                  lm_beta=BETA)
        build.reset_launches()
        grid = pb.prefix_beam_search(logits, lens, **kw)
        torch.cuda.synchronize()
        name = "prefix_beam_rnn_topa" if A else "prefix_beam_rnn"
        if {k: v for k, v in build.LAUNCHES.items() if v} != {name: 1}:
            raise RuntimeError(f"rnn_grid_witness: not the grid: {dict(build.LAUNCHES)}")
        f32 = pb.prefix_beam_search_plain(logits, lens, **kw)
        f64 = plain64(logits, lens, A, L, lm)
        rec = {"gain": gain, "max_len": L, "B": B, "A": A, "layers": nl,
               "route": beam_cuda.rnn_grid_route(B, K, A or V, V, nl, 16, 32,
                                                 build.sm_count(device.index))._asdict(),
               "grid_vs_f32": rows_differing(grid, f32),
               "grid_vs_f64": rows_differing(grid, f64),
               "f32_vs_f64": rows_differing(f32, f64)}
        rec["scores"] = {str(r): {"grid": grid[2][r].item(), "f32": f32[2][r].item(),
                                  "f64": f64[2][r].item(),
                                  "lengths": [grid[1][r].item(), f32[1][r].item(),
                                              f64[1][r].item()]}
                         for r in sorted(set(rec["grid_vs_f32"] + rec["grid_vs_f64"]))}
        rec["near_tie"] = {str(r): near_tie(logits[r:r + 1], lens[r:r + 1], A, L, lm,
                                            tuple(x[r:r + 1] for x in grid))
                           for r in rec["grid_vs_f64"]}
        print(json.dumps(rec))
        tot = totals.setdefault(f"gain {gain:g}, max_len {L}", {
            "rows": 0, "grid_vs_f32": 0, "grid_vs_f64": 0, "f32_vs_f64": 0})
        tot["rows"] += B
        for key in ("grid_vs_f32", "grid_vs_f64", "f32_vs_f64"):
            tot[key] += len(rec[key])
    print(json.dumps({"summary": totals}))
    return totals


if __name__ == "__main__":
    main()
