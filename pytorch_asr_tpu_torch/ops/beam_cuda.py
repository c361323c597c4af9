"""CTC prefix beam search on the card: the kernels of ``csrc/prefix_beam.cu``.

Counterparts of ``pytorch_asr_tpu/ops/beam_pallas.py``'s
``prefix_beam_fused_lanes`` (K7, all chars) and
``prefix_beam_fused_lanes_topa`` (K8, each frame's top-A chars), both with an
optional dense n-gram table or the hashed n-gram LM of
``decoding/lm_hashed.py``, its tables read in the kernel (``prefix_beam``;
counted ``prefix_beam_hashed``, ``prefix_beam_topa_hashed``), and of
``prefix_beam_fused_lanes_topa_rnn`` (K9, either search fused with the char
LSTM LM, advanced inside the kernel: ``prefix_beam_rnn``), and of
``merge_topk_fused`` (K10, one frame's merge and top-K for the beam-sharded
search: ``merge_topk``).  And, from ``csrc/prefix_beam_study.cu``, two more
designs of the search without an LM, kept in the JAX package as measured
studies and reached only by its benchmark scripts: ``prefix_beam_fused``
(K13, the tokens carried in the block) and ``prefix_beam_lanes_stepwise``
(K12, one launch a frame), with the JAX names and arguments, logits in.
Each wrapper takes its plain version (``decoding/prefix_beam.py::
beam_scan_plain``, ``::_merge_topk``, ``::prefix_beam_stepwise_plain``) for
CPU tensors and launches its kernel for CUDA tensors; there is no other
switch and no fallback.

K7, K8 and K9's block form keep a block's working set in shared memory
where it fits (``fits``), and otherwise launch the same kernel with it in a
device scratch (the kernel's ``kInScratch`` form: any beam, any lane
count), counted under ``<name>_wide``; so do K13 and K12 (``study_fits``:
``prefix_beam_fused_wide``, ``prefix_beam_stepwise_wide``).  K9 runs on a co-resident grid, one
CTA an SM holding its units' columns of the LM's weights, where
``rnn_grid_route`` finds its shapes fit (counted as ``prefix_beam_rnn`` and
``prefix_beam_rnn_topa``), and otherwise in its block form, counted as
``prefix_beam_rnn_block`` (``..._topa_block``) or, in a scratch, ``_wide``.
Every form is chosen from the shapes before the launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as plain
from pytorch_asr_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"prefix_beam": [_P] * 10 + [_I] * 7 + [_F, _F, _P, _P, _P, _P],
               "prefix_beam_hashed": [_P] * 7 + [_I, _P, _I] + [_P] * 5 + [_I] * 6
               + [_F, _F, _P, _P, _P, _P],
               "prefix_beam_rnn": [_P] * 6 + [_I] * 3 + [_P] * 5 + [_I] * 6
               + [_F, _F, _P, _I, _P, _P],
               "prefix_beam_rnn_grid": [_P] * 6 + [_I] * 3 + [_P] * 5 + [_I] * 6
               + [_F, _F] + [_P] * 4 + [_I] * 6 + [_P, _P],
               "merge_topk": [_P] * 24 + [_I] * 5 + [_P]}
_STUDY_SIGNATURES = {"prefix_beam_fused": [_P] * 5 + [_I] * 5 + [_P] * 3,
                     "prefix_beam_stepwise": [_P] * 12 + [_I] * 5 + [_P] * 3}
MAX_SMEM = 232448    # the dynamic shared memory a Hopper block may use
MAX_BEAM = 1024      # the shared forms' beams; past it the kernels' in-scratch form
_INT_MAX = 2 ** 31 - 1
# csrc/prefix_beam.cu::Place: where K9's block keeps its working set.
SHARED, LM_STATE_IN_SCRATCH, IN_SCRATCH = 0, 1, 2


def smem_bytes(K: int, C: int, V: int, W: int = 0) -> int:
    """Shared memory of one K7/K8 block, as ``csrc/prefix_beam.cu`` lays it
    out; with the hashed LM (windows ``W`` = order - 1 > 0, its
    ``hashed_smem_bytes``) from the next 16-byte boundary each beam's two
    windows and its W context levels' keys, backoff and validity.  The
    tables stay in device memory."""
    base = 72 * K + 17 * K * C + 8 * V + 8 * C + 512
    return _up(base, 16) + 24 * K * W if W else base


def lm_state_floats(K: int, V: int, nl: int, H: int) -> int:
    """One K9 block's LM state: double-buffered h and c, (2, nl, K, H) each,
    and double-buffered log-prob rows (2, K, V)."""
    return 4 * nl * K * H + 2 * K * V


def rnn_smem_bytes(K: int, C: int, V: int, nl: int, E: int, H: int,
                   state_in_smem: bool = True) -> int:
    """Shared memory of one K9 block: the search's, then from the next
    16-byte boundary the LM's packed inputs, its state (unless that lives in
    a global scratch) and 3 K + 1 ints."""
    groups = (K + 3) // 4
    state = lm_state_floats(K, V, nl, H) if state_in_smem else 0
    lm = 4 * (groups * 4 * (max(E, H) + H) + state) + 4 * (3 * K + 1)
    return (smem_bytes(K, C, V) + 15) // 16 * 16 + lm


def fits(K: int, C: int, V: int, lm: tuple[int, int, int] | None = None, W: int = 0) -> bool:
    """Whether one K7/K8 block (``lm`` None) or one K9 block (``lm`` = the
    char LM's (layers, E, H), its state in a device scratch where need be)
    takes beam K over C candidate lanes of a vocabulary V in shared memory:
    K at most MAX_BEAM and the block's shared memory at most MAX_SMEM.  A
    pure function of the shapes, as the JAX package's lane-kernel gate is
    (``lanes <= 2048``); where it is False, ``prefix_beam`` and
    ``prefix_beam_rnn`` launch the kernel with the working set in a device
    scratch (``scratch_bytes``).  ``W``: the hashed LM's window width.  (A
    beam below 1 "fits": the wrappers refuse it.)"""
    if K > MAX_BEAM:
        return False
    if lm is None:
        return smem_bytes(K, C, V, W) <= MAX_SMEM
    nl, E, H = lm
    return rnn_smem_bytes(K, C, V, nl, E, H, state_in_smem=False) <= MAX_SMEM


def scratch_bytes(K: int, C: int, V: int, lm: tuple[int, int, int] | None = None,
                  W: int = 0) -> int:
    """One block's slice of the device scratch where the working set does
    not fit (``csrc/prefix_beam.cu::scratch_block_bytes``, and
    ``hashed_block_bytes`` for the hashed LM's ``W``): the block's working
    set as shared memory lays it out (K9's with its LM state), to a 16-byte
    boundary."""
    work = smem_bytes(K, C, V, W) if lm is None else rnn_smem_bytes(K, C, V, *lm)
    return (work + 15) // 16 * 16


def _scratch(B: int, nbytes: int, dev) -> torch.Tensor:
    """B slices of ``nbytes`` (a multiple of 16) as float32, 16-byte aligned
    as the caching allocator aligns every block."""
    return torch.empty((B * nbytes // 4,), dtype=torch.float32, device=dev)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def rnn_grid_smem_bytes(B: int, K: int, C: int, V: int, nl: int, H: int, units: int,
                        rows: int, per_cta: int) -> int:
    """Shared memory of one CTA of K9's grid (``csrc/prefix_beam.cu::
    rnn_grid_smem_bytes``): ``rows`` staged rows, each 2H floats (to a
    multiple of 4), 16 bytes of (utterance, slots, char) and the parent's
    cells of the CTA's ``units``; each layer's 4 ``units`` weight columns (H
    rows for layer 0, 2H above), layer 0's (V, 4 units) input table, the
    biases, w_out (H, V) in rows of V | 1 floats and b_out (V), to a
    multiple of 4 floats; the B lengths to a multiple of 4; all
    that to 16 bytes; then ``per_cta`` utterances, each its search's working
    set, the log-prob rows of its 2K state slots and 7 K + 1 ints, to 16
    bytes."""
    u4 = 4 * units
    fixed = _up(u4 * (H + (nl - 1) * 2 * H) + V * u4 + nl * u4 + H * (V | 1) + V, 4)
    shared = _up(rows * (4 * _up(2 * H, 4) + 16 + 4 * units) + 4 * fixed + 4 * _up(B, 4), 16)
    utt = _up(_up(smem_bytes(K, C, V), 16) + 8 * K * V + 4 * (7 * K + 1), 16)
    return shared + per_cta * utt


class RnnGrid(NamedTuple):
    """K9's co-resident grid: ``ctas`` CTAs (one an SM) in ``reps`` runs,
    each run covering H with ``units`` hidden units a CTA (the last of a
    run may own fewer) and stepping 1/reps of a frame's appending beams,
    ``rows`` of them staged at once; up to ``per_cta`` utterances' searches
    a CTA (utterance b on CTA b mod ctas); ``smem`` bytes of shared memory
    a CTA."""
    ctas: int
    units: int
    rows: int
    per_cta: int
    smem: int
    reps: int = 1


GRID_REPS = (2, 1)   # the runs rnn_grid_route tries, in turn


def rnn_grid_route(B: int, K: int, C: int, V: int, nl: int, E: int, H: int,
                   sms: int = build.SMS) -> RnnGrid | None:
    """K9's route for B utterances at beam K over C candidate lanes of a
    vocabulary V, with an LM of ``nl`` layers, embedding E and width H, on a
    card of ``sms`` SMs: the co-resident grid where it fits, else None (the
    block kernel).

    For R in GRID_REPS, in turn: R runs of sms // R SMs each hold every
    unit's columns, ``units`` = ceil(H / (sms // R)) a CTA, ``ctas`` = R
    ceil(H / units); ``per_cta`` = ceil(B / ctas); ``rows`` is every beam of
    the batch (B K) where they fit, else as many as fit; the first R whose
    CTA (``rnn_grid_smem_bytes`` with at least K rows) is within MAX_SMEM
    is the grid.  More runs stage
    fewer rows a CTA from L2 for more columns.  E does not enter: layer 0's
    input product is a (V, 4 units) table.  A pure function of the shapes
    and the card, decided before the launch."""
    if nl < 1 or B < 1 or K < 1:
        return None
    for R in GRID_REPS:
        if sms // R < 1:
            continue
        units = -(-H // (sms // R))
        ctas = R * -(-H // units)
        per_cta = -(-B // ctas)
        base = rnn_grid_smem_bytes(B, K, C, V, nl, H, units, 0, per_cta)
        per_row = 4 * _up(2 * H, 4) + 16 + 4 * units
        rows = min(B * K, (MAX_SMEM - base) // per_row)
        while rows >= K and rnn_grid_smem_bytes(B, K, C, V, nl, H, units, rows,
                                                per_cta) > MAX_SMEM:
            rows -= 1     # the 16-byte rounding of the shared part
        if rows >= K:
            return RnnGrid(ctas, units, rows, per_cta,
                           rnn_grid_smem_bytes(B, K, C, V, nl, H, units, rows, per_cta), R)
    return None


def merge_smem_bytes(Ks: int, nb: int) -> int:
    """One K10 block's working set, as ``csrc/prefix_beam.cu`` lays it out:
    the N = Ks + Ks nb keys and 512 bytes of room past them, the stays' pb,
    pnb and hash, the lanes' pnb and absorbed flags."""
    N = Ks + Ks * nb
    return 8 * N + 512 + 12 * Ks + 5 * Ks * nb


def merge_slice_bytes(Ks: int, nb: int) -> int:
    """One K10 block's slice of the device scratch where its working set
    does not fit: ``merge_smem_bytes`` to a 16-byte boundary."""
    return _up(merge_smem_bytes(Ks, nb), 16)


def merge_fits(Ks: int, nb: int) -> bool:
    """Whether one K10 block takes Ks stays over nb lanes each in shared
    memory: Ks at most MAX_BEAM and ``merge_smem_bytes`` at most MAX_SMEM.
    Where it is False, ``merge_topk`` launches the same kernel with the
    working set in a device scratch, counted as ``merge_topk_wide``."""
    return Ks <= MAX_BEAM and merge_smem_bytes(Ks, nb) <= MAX_SMEM


def _check(logp, logit_len, lm_table, top_val, top_idx, K: int, L: int,
           lm_tensors: dict | None = None) -> int:
    """Validates the inputs (``lm_tensors``: K9's LM, name -> (tensor,
    shape)); returns C, the candidate lanes of a beam."""
    B, T, V = logp.shape
    want = {"logp": (logp, (B, T, V), torch.float32),
            "logit_len": (logit_len, (B,), torch.int32)}
    C = V
    if lm_table is not None:
        want["lm_table"] = (lm_table, (lm_table.shape[0], V), torch.float32)
        if lm_table.shape[0] * V >= 2 ** 31:
            raise ValueError(f"prefix_beam: lm_table {tuple(lm_table.shape)} too large")
    if (top_val is None) != (top_idx is None):
        raise ValueError("prefix_beam: give both top_val and top_idx, or neither")
    if top_idx is not None:
        C = top_idx.shape[-1]
        want["top_val"] = (top_val, (B, T, C), torch.float32)
        want["top_idx"] = (top_idx, (B, T, C), torch.int32)
    for name, (t, shape) in (lm_tensors or {}).items():
        want[name] = (t, shape, torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"prefix_beam: {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != logp.device or not t.is_contiguous():
            raise ValueError("prefix_beam: all inputs must be contiguous on one CUDA device")
    if K < 1 or L < 0 or C < 1:
        raise ValueError(f"prefix_beam: beam_size {K} >= 1, max_len {L} >= 0 and lanes "
                         f"{C} >= 1 are needed")
    return C


def hash_table(hash_lm, dev) -> torch.Tensor:
    """``csrc/prefix_beam.cu::HashLm::tables`` of ``hash_lm``: the bucket-row
    arrays' device addresses (probs of orders 2..N, then backoffs of context
    lengths 2..N-1), then each array's bucket mask, as int64 on ``dev``.
    Made once for each distinct table and kept (``_device_table``): a
    search's launches reuse it with no copy."""
    tabs = [t.data for t in (*hash_lm.probs, *hash_lm.backoffs)]
    return _device_table(tuple(t.data_ptr() for t in tabs) + tuple(t.shape[0] - 1 for t in tabs),
                         dev)


@functools.lru_cache(maxsize=16)
def _device_table(vals: tuple, dev) -> torch.Tensor:
    """``vals`` as an int64 tensor on ``dev``.  Keyed by the values
    themselves, so an entry is right for any LM whose arrays lie at those
    addresses with those masks."""
    return torch.tensor(vals, dtype=torch.int64, device=dev)


def _hash_check(hash_lm, V: int, dev) -> None:
    """A hashed LM for the kernel: order >= 2, (V,) unigram and backoff
    rows and (buckets, 32) tables of a power of two buckets, all float32,
    contiguous on ``dev``."""
    if hash_lm.order < 2:
        raise ValueError(f"prefix_beam: a hashed LM of order {hash_lm.order}; the kernel takes "
                         "order >= 2 (a unigram LM is a dense table of one row)")
    tensors = {"uni": (hash_lm.uni, (V,)), "uni_backoff": (hash_lm.uni_backoff, (V,))}
    for i, t in enumerate((*hash_lm.probs, *hash_lm.backoffs)):
        n = t.data.shape[0]
        if n < 1 or n & (n - 1):
            raise ValueError(f"prefix_beam: hash table {i} has {n} buckets, not a power of two")
        tensors[f"table{i}"] = (t.data, (n, 32))
    for name, (t, shape) in tensors.items():
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"prefix_beam: hash_lm.{name} must be contiguous {shape} float32 on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _hashed_launch(logp, logit_len, K: int, L: int, hash_lm, lm_alpha: float, lm_beta: float,
                   top_val, top_idx, exact_idx, trace=None, state=None):
    """K7/K8's hashed form: from the initial beams, or from ``state`` (the
    kCarry form, its ctx (B, K, order - 1) windows), over ``logp``.
    Returns (tokens, lengths, scores) of each row's best beam and the
    BeamState after (None without ``state``)."""
    B, T, V = logp.shape
    C = _check(logp, logit_len, None, top_val, top_idx, K, L)
    dev = logp.device
    _hash_check(hash_lm, V, dev)
    W = hash_lm.order - 1
    n_exact = 0
    if exact_idx is not None:
        if top_idx is not None:
            raise ValueError("prefix_beam: exact_idx (lm_top_k) prunes the search over all chars "
                             "only, not K8's")
        n_exact = exact_idx.shape[-1]
        if (tuple(exact_idx.shape) != (B, T, n_exact) or exact_idx.dtype != torch.int32
                or exact_idx.device != dev or not exact_idx.is_contiguous() or n_exact < 1):
            raise ValueError(f"prefix_beam: exact_idx must be contiguous ({B}, {T}, k >= 1) int32 "
                             f"on {dev}")
    _trace_check("prefix_beam", trace, T, 7, dev)
    table = new = None
    if state is not None:
        if trace is not None:
            raise ValueError("prefix_beam: a carried search takes no trace")
        _state_check(state, B, K, L, dev, W)
        new = _empty_state(B, K, L, dev, W)
        table = carry_table([*state, *new])
    scratch = None if fits(K, C, V, W=W) else _scratch(B, scratch_bytes(K, C, V, W=W), dev)
    parents, appends, tokens, lengths, scores = _outputs_of(B, T, K, L, dev)
    tables = hash_table(hash_lm, dev)
    lib = build.load("prefix_beam", _SIGNATURES)
    name = ("prefix_beam_topa" if top_idx is not None else "prefix_beam") + "_hashed" + (
        "_carry" if state is not None else "") + ("_wide" if scratch is not None else "")
    build.check(lib.prefix_beam_hashed(
        logp.data_ptr(), _ptr(top_val), _ptr(top_idx), logit_len.data_ptr(),
        hash_lm.uni.data_ptr(), hash_lm.uni_backoff.data_ptr(), tables.data_ptr(),
        hash_lm.order, _ptr(exact_idx), n_exact, parents.data_ptr(), appends.data_ptr(),
        tokens.data_ptr(), lengths.data_ptr(), scores.data_ptr(), B, T, V, K, C, L, lm_alpha,
        lm_beta, _ptr(scratch), _ptr(trace), table,
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores, new


# csrc/prefix_beam.cu::RnnLm's table of the layers' 3 nl pointers, kind-major:
# wx of every layer, then wh of every layer, then b (RnnLm::wx, wh, b).
LAYER_KINDS = ("wx", "wh", "b")


def _lm_tensors(rnn_lm, h0, c0, lmp0, V: int) -> tuple[dict, dict]:
    """K9's LM inputs, each with the shape it must have: (the six the
    kernel takes by a host array, in its order, with h0, c0 and lmp0 None
    for a carried search, which reads each beam's state from its carry
    instead; the layers' weights in the order of its device table,
    LAYER_KINDS)."""
    cfg = rnn_lm.cfg
    nl, E, H = cfg.num_layers, cfg.embed_dim, cfg.hidden_dim
    head = {"embed": (rnn_lm.embed, (V, E)), "w_out": (rnn_lm.w_out, (H, V)),
            "b_out": (rnn_lm.b_out, (V,)), "h0": (h0, (nl, H)), "c0": (c0, (nl, H)),
            "lmp0": (lmp0, (V,))}
    layers = {}
    for kind in LAYER_KINDS:
        for l in range(nl):
            shape = {"wx": (E if l == 0 else H, 4 * H), "wh": (H, 4 * H), "b": (4 * H,)}[kind]
            layers[f"lstm{l}_{kind}"] = (getattr(rnn_lm, f"lstm{l}_{kind}"), shape)
    return head, layers


def lm_layer_table(layers: dict, dev) -> torch.Tensor:
    """The kernel's table of the layers' weights: their device pointers as
    int64 in ``_lm_tensors``' order, on ``dev``, copied from pinned memory
    without waiting for the stream."""
    ptrs = torch.tensor([t.data_ptr() for t, _ in layers.values()], dtype=torch.int64)
    return ptrs.pin_memory().to(dev, non_blocking=True)


def _trace_check(name: str, trace, rows: int, cols: int | None, dev) -> None:
    """A trace must be contiguous int64 on ``dev``, (rows, cols), or (rows,)
    for ``cols`` None."""
    shape = (rows,) if cols is None else (rows, cols)
    if trace is not None and (tuple(trace.shape) != shape or trace.dtype != torch.int64
                              or trace.device != dev or not trace.is_contiguous()):
        raise ValueError(f"{name}: trace must be contiguous {shape} int64 on {dev}")


def _outputs_of(B: int, T: int, K: int, L: int, dev):
    """(parents, appends (B, T, K) int32 scratch, then ``_outputs``)."""
    parents = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    return (parents, torch.empty_like(parents), *_outputs(B, L, dev))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def prefix_beam(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int, max_len: int,
                lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                lm_beta: float = 0.0, top_val: torch.Tensor | None = None,
                top_idx: torch.Tensor | None = None, trace: torch.Tensor | None = None,
                hash_lm=None, exact_idx: torch.Tensor | None = None):
    """Prefix beam search over log-probs ``logp`` (B, T, V) float32 with
    lengths ``logit_len`` (B,) int32 and, optionally, a dense LM table
    (n_ctx, V) float32 fused as ``lm_alpha * row + lm_beta`` a char.  With
    ``top_val``/``top_idx`` (B, T, A) the extensions are each frame's top-A
    chars (K8), else all chars (K7).  Returns (tokens (B, max_len) int32,
    lengths (B,) int32, scores (B,) float32) of the best beam of each row.
    Where a block's working set does not fit its shared memory (``fits``)
    it lies in a device scratch this wrapper allocates, counted under
    ``<name>_wide``.  ``trace``, a (T, 7) int64 tensor on the card,
    receives block 0's clocks of each frame
    (``csrc/prefix_beam.cu::search_frame``).  With ``hash_lm`` (a
    ``decoding.lm_hashed.HashedNgramLM`` on logp's device, in
    ``lm_table``'s place) the kernel's hashed form reads its tables, counted
    as ``prefix_beam_hashed`` (``prefix_beam_topa_hashed``); ``exact_idx``
    (B, T, k) int32, K7 only: each frame's top k chars of ``lm_top_k``,
    whose rows are exact while the rest take the all-miss rows."""
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, logit_len, beam_size, max_len, lm_table, lm_alpha,
                                     lm_beta, top_val, top_idx, hash_lm=hash_lm,
                                     exact_idx=exact_idx)
    if hash_lm is not None:
        return _hashed_launch(logp, logit_len, beam_size, max_len, hash_lm, lm_alpha, lm_beta,
                              top_val, top_idx, exact_idx, trace)[:3]
    B, T, V = logp.shape
    K, L = beam_size, max_len
    C = _check(logp, logit_len, lm_table, top_val, top_idx, K, L)
    dev = logp.device
    _trace_check("prefix_beam", trace, T, 7, dev)
    scratch = None if fits(K, C, V) else _scratch(B, scratch_bytes(K, C, V), dev)
    parents, appends, tokens, lengths, scores = _outputs_of(B, T, K, L, dev)
    lib = build.load("prefix_beam", _SIGNATURES)
    name = ("prefix_beam_topa" if top_idx is not None else "prefix_beam") + (
        "_wide" if scratch is not None else "")
    build.check(lib.prefix_beam(
        logp.data_ptr(), _ptr(top_val), _ptr(top_idx), logit_len.data_ptr(), _ptr(lm_table),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, C, L, lm_table.shape[0] if lm_table is not None else 1,
        lm_alpha, lm_beta, _ptr(scratch), _ptr(trace), None,
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores


def prefix_beam_rnn(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int, max_len: int,
                    rnn_lm, h0: torch.Tensor, c0: torch.Tensor, lmp0: torch.Tensor,
                    lm_alpha: float, lm_beta: float, top_val: torch.Tensor | None = None,
                    top_idx: torch.Tensor | None = None):
    """Prefix beam search over ``logp`` (B, T, V) float32 with lengths
    ``logit_len`` (B,) int32, fused with the char LSTM LM ``rnn_lm``
    (``models.lm_rnn.CharRNNLM``, float32 on logp's device): every beam
    starts from the state after ``<sos>``, ``h0``/``c0`` (layers, H) and
    ``lmp0`` (V,) (``decoding.prefix_beam.primed_lm_state``), and an
    extension by c scores ``lm_alpha * logP(c | prefix) + lm_beta``.  With
    ``top_val``/``top_idx`` (B, T, A) the extensions are each frame's top-A
    chars, else all chars.  Returns (tokens (B, max_len) int32, lengths (B,)
    int32, scores (B,) float32) of the best beam of each row.  It runs on
    the co-resident grid where ``rnn_grid_route`` finds the shapes fit, else
    in the block kernel (``rnn_on_route``); an LM of any number of layers."""
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, logit_len, beam_size, max_len, None, lm_alpha,
                                     lm_beta, top_val, top_idx, rnn_lm=rnn_lm,
                                     lm_state=(h0, c0, lmp0))
    cfg = rnn_lm.cfg
    C = top_idx.shape[-1] if top_idx is not None else logp.shape[-1]
    route = rnn_grid_route(logp.shape[0], beam_size, C, logp.shape[-1], cfg.num_layers,
                           cfg.embed_dim, cfg.hidden_dim, build.sm_count(logp.device.index))
    return rnn_on_route(route, logp, logit_len, beam_size, max_len, rnn_lm, h0, c0, lmp0,
                        lm_alpha, lm_beta, top_val, top_idx)


def rnn_on_route(route: RnnGrid | None, logp: torch.Tensor, logit_len: torch.Tensor,
                 beam_size: int, max_len: int, rnn_lm, h0: torch.Tensor, c0: torch.Tensor,
                 lmp0: torch.Tensor, lm_alpha: float, lm_beta: float,
                 top_val: torch.Tensor | None = None, top_idx: torch.Tensor | None = None,
                 trace: torch.Tensor | None = None):
    """``prefix_beam_rnn`` on CUDA tensors along the route given: K9 on the
    grid ``route`` (an ``RnnGrid``: one cooperative launch, which raises
    where the grid cannot be resident at once), counted as
    ``prefix_beam_rnn`` (``..._topa``), with ``trace`` a (T, 5 + 3 layers)
    int64 tensor for CTA 0's clocks of each frame; or for None the block
    kernel: its working set in shared memory, or the beams' LM state in a
    device scratch where it does not fit beside the search, counted as
    ``prefix_beam_rnn_block`` (``..._topa_block``); or where the rest does
    not fit either (the LM step's packed inputs, K x (max(E, H) + H) floats,
    past the block's shared memory, or K > MAX_BEAM: ``fits``) all of it in
    a device scratch, counted as ``prefix_beam_rnn_wide`` (``..._topa_wide``)."""
    return _rnn_launch(route, logp, logit_len, beam_size, max_len, rnn_lm, (h0, c0, lmp0),
                       lm_alpha, lm_beta, top_val, top_idx, trace)[:3]


def _rnn_launch(route: RnnGrid | None, logp, logit_len, K: int, L: int, rnn_lm, primed,
                lm_alpha: float, lm_beta: float, top_val, top_idx, trace=None, carry=None):
    """K9's launch on ``route``: from every beam primed with ``primed`` =
    (h0, c0, lmp0), or for ``carry`` = (BeamState, LMCarry) from that state
    (the kCarry form, counted under its name with ``_carry`` before the
    route's suffix), handing the state after the frames on.  Returns
    (tokens, lengths, scores) of each row's best beam, and the BeamState
    and LMCarry after (None without ``carry``)."""
    B, T, V = logp.shape
    cfg = rnn_lm.cfg
    nl, E, H = cfg.num_layers, cfg.embed_dim, cfg.hidden_dim
    head, layers = _lm_tensors(rnn_lm, *(primed if carry is None else (None,) * 3), V)
    C = _check(logp, logit_len, None, top_val, top_idx, K, L,
               {n: v for n, v in {**head, **layers}.items() if v[0] is not None})
    if nl < 1:
        raise ValueError(f"prefix_beam_rnn: {nl} LM layers; the kernel takes at least 1")
    dev = logp.device
    if trace is not None and (route is None or carry is not None):
        raise ValueError("prefix_beam_rnn: a trace is taken on the grid route only, and not "
                         "by a carried search")
    _trace_check("prefix_beam_rnn", trace, T, 5 + 3 * nl, dev)
    new = new_carry = table = None
    if carry is not None:
        state, lm_carry = carry
        _state_check(state, B, K, L, dev)
        _lm_carry_check(lm_carry, nl, B, K, H, V, dev)
        new, new_carry = _empty_state(B, K, L, dev), _empty_lm_carry(nl, B, K, H, V, dev)
        table = carry_table([*state, *new, *lm_carry, *new_carry])
    parents, appends, tokens, lengths, scores = _outputs_of(B, T, K, L, dev)
    weights = (_P * len(head))(*(_ptr(t) for t, _ in head.values()))
    layer_table = lm_layer_table(layers, dev)
    lib = build.load("prefix_beam", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = ("prefix_beam_rnn_topa" if top_idx is not None else "prefix_beam_rnn") + (
        "_carry" if carry is not None else "")
    common = (logp.data_ptr(), _ptr(top_val), _ptr(top_idx), logit_len.data_ptr(), weights,
              layer_table.data_ptr(), nl, E, H, parents.data_ptr(), appends.data_ptr(),
              tokens.data_ptr(), lengths.data_ptr(), scores.data_ptr(), B, T, V, K, C, L,
              lm_alpha, lm_beta)
    if route is not None:
        slots = torch.empty((4 * B * K * nl * H,), dtype=torch.float32, device=dev)
        rows = torch.empty((4 * B * K,), dtype=torch.int32, device=dev)
        sync = torch.zeros((3,), dtype=torch.int32, device=dev)
        build.check(lib.prefix_beam_rnn_grid(
            *common, slots.data_ptr(), rows.data_ptr(), sync.data_ptr(), _ptr(trace),
            route.ctas, route.units, route.rows, route.per_cta, route.reps, route.smem,
            table, stream), name)
    else:
        place, scratch = SHARED, None
        if not fits(K, C, V, (nl, E, H)):
            place, scratch = IN_SCRATCH, _scratch(B, scratch_bytes(K, C, V, (nl, E, H)), dev)
        elif rnn_smem_bytes(K, C, V, nl, E, H) > MAX_SMEM:
            place = LM_STATE_IN_SCRATCH
            scratch = torch.empty((B, lm_state_floats(K, V, nl, H)), dtype=torch.float32,
                                  device=dev)
        name += "_wide" if place == IN_SCRATCH else "_block"
        build.check(lib.prefix_beam_rnn(*common, _ptr(scratch), place, table, stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores, new, new_carry


# ------------------------------------- the carried forms: a chunk of a stream

# csrc/prefix_beam.cu::BeamCarry: the state before the chunk, the state
# after it, then K9's LM state before and after; 22 device pointers.
CARRY_POINTERS = 2 * len(plain.BeamState._fields) + 2 * len(plain.LMCarry._fields)


def carry_table(tensors: list):
    """The kernels' BeamCarry as the C entries take it: a host array of the
    tensors' device pointers (null past them: K7 and K8 carry no LM state),
    which the entry passes to the kernel by value."""
    return (_P * CARRY_POINTERS)(*(t.data_ptr() for t in tensors))


def _state_check(state, B: int, K: int, L: int, dev, W: int = 0) -> None:
    """A carried BeamState must be B rows of K beams of L tokens (and, for
    a hashed LM, (B, K, W) context windows), each field contiguous on
    ``dev`` in its dtype."""
    for name, t in state._asdict().items():
        shape = (B, K, L) if name == "tokens" else (B, K, W) if name == "ctx" and W else (B, K)
        dtype = torch.float32 if name in ("pb", "pnb", "lm_s") else torch.int32
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"prefix_beam: state.{name} must be contiguous {shape} {dtype} on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _lm_carry_check(carry, nl: int, B: int, K: int, H: int, V: int, dev) -> None:
    for name, t in carry._asdict().items():
        shape = (B, K, V) if name == "logp" else (nl, B, K, H)
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"prefix_beam_rnn: lm_carry.{name} must be contiguous {shape} "
                             f"float32 on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _empty_state(B: int, K: int, L: int, dev, W: int = 0):
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    return plain.BeamState(tokens=torch.empty((B, K, L), **i32),
                           **{f: torch.empty((B, K, W) if f == "ctx" and W else (B, K),
                                             **(f32 if f in ("pb", "pnb", "lm_s") else i32))
                              for f in plain.BeamState._fields[1:]})


def _empty_lm_carry(nl: int, B: int, K: int, H: int, V: int, dev):
    return plain.LMCarry(*(torch.empty(s, dtype=torch.float32, device=dev)
                           for s in ((nl, B, K, H), (nl, B, K, H), (B, K, V))))


def prefix_beam_carry(state, logp: torch.Tensor, n_valid: torch.Tensor,
                      lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                      lm_beta: float = 0.0, top_val: torch.Tensor | None = None,
                      top_idx: torch.Tensor | None = None, hash_lm=None,
                      exact_idx: torch.Tensor | None = None):
    """One chunk of a stream's search: ``prefix_beam`` (K7, or K8 with
    ``top_val``/``top_idx``) from the beams of ``state``, a
    ``decoding.prefix_beam.BeamState`` of B rows of K beams of L tokens,
    over the chunk's log-probs ``logp`` (B, T, V), row b's first
    ``n_valid[b]`` frames (int32; later frames leave the row as it is).
    Returns (the BeamState after the chunk, in new tensors, and the best
    beam's (tokens (B, L) int32, lengths (B,) int32, scores (B,) float32)),
    those of ``decoding.prefix_beam.continue_plain`` and ``beam_best``, which
    it runs on CPU tensors.  Counted as ``prefix_beam_carry``
    (``prefix_beam_topa_carry``), or ``..._carry_wide`` past ``fits``.  With
    ``hash_lm`` (``exact_idx`` as ``prefix_beam`` takes it) the state's ctx
    is its (B, K, order - 1) windows and the hashed form runs, counted as
    ``prefix_beam_hashed_carry`` (``prefix_beam_topa_hashed_carry``)."""
    if logp.device.type == "cpu":
        new, _ = plain.continue_plain(state, logp, n_valid, lm_table, lm_alpha, lm_beta,
                                      top_val, top_idx, hash_lm=hash_lm, exact_idx=exact_idx)
        return new, plain.beam_best(new)
    if hash_lm is not None:
        tokens, lengths, scores, new = _hashed_launch(
            logp, n_valid, state.tokens.shape[1], state.tokens.shape[2], hash_lm, lm_alpha,
            lm_beta, top_val, top_idx, exact_idx, state=state)
        return new, (tokens, lengths, scores)
    B, T, V = logp.shape
    K, L = state.tokens.shape[1:]
    C = _check(logp, n_valid, lm_table, top_val, top_idx, K, L)
    dev = logp.device
    _state_check(state, B, K, L, dev)
    scratch = None if fits(K, C, V) else _scratch(B, scratch_bytes(K, C, V), dev)
    parents, appends, tokens, lengths, scores = _outputs_of(B, T, K, L, dev)
    new = _empty_state(B, K, L, dev)
    table = carry_table([*state, *new])
    lib = build.load("prefix_beam", _SIGNATURES)
    name = ("prefix_beam_topa" if top_idx is not None else "prefix_beam") + "_carry" + (
        "_wide" if scratch is not None else "")
    build.check(lib.prefix_beam(
        logp.data_ptr(), _ptr(top_val), _ptr(top_idx), n_valid.data_ptr(), _ptr(lm_table),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, C, L, lm_table.shape[0] if lm_table is not None else 1,
        lm_alpha, lm_beta, _ptr(scratch), None, table,
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return new, (tokens, lengths, scores)


def prefix_beam_rnn_carry(state, lm_carry, logp: torch.Tensor, n_valid: torch.Tensor, rnn_lm,
                          lm_alpha: float, lm_beta: float, top_val: torch.Tensor | None = None,
                          top_idx: torch.Tensor | None = None):
    """One chunk of a stream's search fused with the char LSTM LM
    ``rnn_lm``: ``prefix_beam_rnn`` from the beams of ``state`` and each
    beam's LM state in ``lm_carry`` (a ``decoding.prefix_beam.LMCarry``,
    h and c (layers, B, K, H), logp (B, K, V)), over row b's first
    ``n_valid[b]`` frames of ``logp``.  Returns (BeamState, LMCarry after
    the chunk, in new tensors, best (tokens, lengths, scores)), those of
    ``decoding.prefix_beam.continue_plain`` and ``beam_best``, which it runs on
    CPU tensors.  On the route ``rnn_grid_route`` gives (the offline
    search's: the route does not depend on T), counted as
    ``prefix_beam_rnn_carry`` (``prefix_beam_rnn_topa_carry``), or off the
    grid ``..._carry_block`` / ``..._carry_wide`` (``rnn_carry_on_route``)."""
    if logp.device.type == "cpu":
        new, carry = plain.continue_plain(state, logp, n_valid, None, lm_alpha, lm_beta,
                                          top_val, top_idx, rnn_lm=rnn_lm, lm_carry=lm_carry)
        return new, carry, plain.beam_best(new)
    cfg = rnn_lm.cfg
    B, K = state.pb.shape
    C = top_idx.shape[-1] if top_idx is not None else logp.shape[-1]
    route = rnn_grid_route(B, K, C, logp.shape[-1], cfg.num_layers, cfg.embed_dim,
                           cfg.hidden_dim, build.sm_count(logp.device.index))
    return rnn_carry_on_route(route, state, lm_carry, logp, n_valid, rnn_lm, lm_alpha, lm_beta,
                              top_val, top_idx)


def rnn_carry_on_route(route: RnnGrid | None, state, lm_carry, logp: torch.Tensor,
                       n_valid: torch.Tensor, rnn_lm, lm_alpha: float, lm_beta: float,
                       top_val: torch.Tensor | None = None,
                       top_idx: torch.Tensor | None = None):
    """``prefix_beam_rnn_carry`` on CUDA tensors along the route given, as
    ``rnn_on_route`` chooses the block kernel's place for None."""
    K, L = state.tokens.shape[1:]
    tokens, lengths, scores, new, carry = _rnn_launch(
        route, logp, n_valid, K, L, rnn_lm, None, lm_alpha, lm_beta, top_val, top_idx,
        carry=(state, lm_carry))
    return new, carry, (tokens, lengths, scores)


_MERGE_IN = (("stay", "pb", torch.float32), ("stay", "pnb", torch.float32),
             ("stay", "lm", torch.float32), ("stay", "hash", torch.int32),
             ("stay", "last", torch.int32), ("stay", "parent", torch.int32),
             ("stay", "ctx", torch.int32), ("ext", "pnb", torch.float32),
             ("ext", "lm", torch.float32), ("ext", "hash", torch.int32),
             ("ext", "parent", torch.int32), ("ext", "append", torch.int32),
             ("ext", "ctx", torch.int32))
_MERGE_OUT = (("pb", torch.float32), ("pnb", torch.float32), ("lm", torch.float32),
              ("hash", torch.int32), ("last", torch.int32), ("parent", torch.int32),
              ("append", torch.int32), ("ctx", torch.int32))


def merge_topk(stay: dict, ext: dict, K: int, trace: torch.Tensor | None = None):
    """One frame's merge and top-K of the beam-sharded search: absorb each
    extension into the alive stay of the same prefix, keep the K best of the
    stays and the extension lanes (stays first on ties, then the lower flat
    index), and pick every field.  ``stay`` holds (B, Ks) fields pb, pnb, lm
    (float32), hash, last, parent, ctx (int32); ``ext`` (B, Ks, V-1) fields
    pnb, lm, hash, parent, append, ctx, lane (k, c-1) beam k's extension by
    char c (``_build_candidates``' layout), whose last char is ``append``.
    Returns (score (B, K), fields: pb, pnb, lm, hash, last, parent, append,
    ctx (B, K)), the contract of ``decoding/prefix_beam.py::_merge_topk``.
    With the hashed LM's windows, stay ctx (B, Ks, C) and ext ctx (B, Ks,
    V-1, C), the kernel's window form copies each pick's C columns into a
    (B, K, C) ctx.
    Where a block's working set does not fit its shared memory
    (``merge_fits``) it lies in a device scratch this wrapper allocates,
    counted as ``merge_topk_wide``.  ``trace``, a (7,) int64 tensor on the
    card, receives block 0's clocks (``csrc/prefix_beam.cu::
    merge_topk_kernel``)."""
    if stay["pb"].device.type == "cpu":
        return plain._merge_topk(stay, ext, K)
    B, Ks = stay["pb"].shape
    nb = ext["pnb"].shape[2]
    cols = stay["ctx"].shape[2] if stay["ctx"].dim() == 3 else 0
    ins = []
    for part, name, dtype in _MERGE_IN:
        t = (stay if part == "stay" else ext)[name]
        shape = (B, Ks) if part == "stay" else (B, Ks, nb)
        if name == "ctx" and cols:
            shape += (cols,)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"merge_topk: {part}[{name!r}] must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != stay["pb"].device or not t.is_contiguous():
            raise ValueError("merge_topk: all inputs must be contiguous on one CUDA device")
        ins.append(t)
    N = Ks + Ks * nb
    if not 1 <= K <= N:
        raise ValueError(f"merge_topk: K {K} must be in 1..{N} candidates")
    if N + 64 > _INT_MAX:
        raise ValueError(f"merge_topk: {Ks} x {nb} lanes pass the kernel's int32 indices")
    dev = stay["pb"].device
    _trace_check("merge_topk", trace, 7, None, dev)
    scratch = None if merge_fits(Ks, nb) else _scratch(B, merge_slice_bytes(Ks, nb), dev)
    name = "merge_topk" + ("_wide" if scratch is not None else "")
    score = torch.empty((B, K), dtype=torch.float32, device=dev)
    out = {f: torch.empty((B, K, cols) if f == "ctx" and cols else (B, K), dtype=dtype,
                          device=dev) for f, dtype in _MERGE_OUT}
    lib = build.load("prefix_beam", _SIGNATURES)
    build.check(lib.merge_topk(
        *(t.data_ptr() for t in ins), score.data_ptr(), *(t.data_ptr() for t in out.values()),
        _ptr(scratch), _ptr(trace), B, Ks, nb, K, cols,
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return score, out


# ------------------------------------------------- K12, K13: csrc/prefix_beam_study.cu


def frame_bytes(K: int, V: int) -> int:
    """One frame's working set in ``csrc/prefix_beam_study.cu``: the keys
    and 32 zeros for the merge tree, the stay and lane candidates and the
    row, the lanes' absorbed flags."""
    KC = K * (V - 1)
    return 8 * (K + KC + 32) + 4 * (2 * K + KC + V) + KC


def fused_bytes(K: int, V: int, L: int) -> int:
    """One K13 block's working set: the frame's, two sets of the 5 beam
    fields and 3 K pick ints, then from the next 16 bytes the token buffers
    (2, K, L) int32, to 16 bytes: its shared memory, or its slice of the
    scratch."""
    return _up(_up(frame_bytes(K, V) + 52 * K, 16) + 8 * K * L, 16)


def step_bytes(K: int, V: int) -> int:
    """One K12 block's working set: the frame's and its row's 5 state
    fields, to 16 bytes."""
    return _up(frame_bytes(K, V) + 20 * K, 16)


def study_fits(K: int, V: int, L: int | None = None) -> bool:
    """Whether one K13 block (max_len ``L``) or one K12 block (``L`` None)
    takes beam K over a vocabulary V in shared memory: K at most MAX_BEAM and
    the working set at most MAX_SMEM.  Where it is False the wrappers launch
    the same kernel with the working set in a device scratch, counted under
    ``<name>_wide``.  A pure function of the shapes."""
    need = step_bytes(K, V) if L is None else fused_bytes(K, V, L)
    return K <= MAX_BEAM and need <= MAX_SMEM


def _study_inputs(name: str, logits, logit_len, blank: int, K: int, L: int):
    """(logp, lens) for K12/K13: log-softmax first, as the JAX functions do;
    on the card, checked as ``_check_study`` checks them."""
    plain._check_sources(blank, None, None, None)
    logp = torch.log_softmax(logits.float(), dim=-1).contiguous()
    lens = logit_len.to(torch.int32).contiguous()
    if logp.device.type != "cpu":
        _check_study(name, logp, lens, K, L)
    return logp, lens


def _check_study(name: str, logp, lens, K: int, L: int) -> None:
    """Refuses what the kernels cannot index: beyond the shapes' own limits,
    only candidates K + K (V-1) or token ints 2 K L past int32."""
    B, T, V = logp.shape
    if tuple(lens.shape) != (B,) or lens.device != logp.device:
        raise ValueError(f"{name}: logit_len must be ({B},) on {logp.device}")
    if V < 2 or K < 1 or L < 0:
        raise ValueError(f"{name}: vocabulary {V} >= 2, beam_size {K} >= 1 and max_len {L} "
                         f">= 0 are needed")
    if K * V > _INT_MAX or 2 * K * L > _INT_MAX:
        raise ValueError(f"{name}: beam {K} x vocabulary {V} (max_len {L}) passes the kernel's "
                         f"int32 indices")


def _outputs(B: int, L: int, dev):
    return (torch.empty((B, L), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def prefix_beam_fused(logits: torch.Tensor, logit_len: torch.Tensor, beam_size: int = 16,
                      blank: int = 0, max_len: int = 256, trace: torch.Tensor | None = None):
    """CTC prefix beam search without an LM in one launch, each beam's
    tokens carried in the block (K13).  ``logits`` (B, T, V) are
    log-softmaxed first.  Returns (tokens (B, max_len) int32, lengths (B,)
    int32, scores (B,) float32) of the best beam of each row, those of
    ``decoding.prefix_beam.beam_scan_plain``.  Where a block's working set
    does not fit its shared memory (``study_fits``) it lies in a device
    scratch, counted as ``prefix_beam_fused_wide``.  ``trace``, a (T, 8)
    int64 tensor on the card, receives block 0's clocks of each frame."""
    K, L = beam_size, max_len
    logp, lens = _study_inputs("prefix_beam_fused", logits, logit_len, blank, K, L)
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, lens, K, L)
    B, T, V = logp.shape
    dev = logp.device
    _trace_check("prefix_beam_fused", trace, T, 8, dev)
    scratch = None if study_fits(K, V, L) else _scratch(B, fused_bytes(K, V, L), dev)
    name = "prefix_beam_fused" + ("_wide" if scratch is not None else "")
    tokens, lengths, scores = _outputs(B, L, dev)
    lib = build.load("prefix_beam_study", _STUDY_SIGNATURES)
    build.check(lib.prefix_beam_fused(
        logp.data_ptr(), lens.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, L, _ptr(scratch), _ptr(trace),
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores


_FIELDS = ("pb", "pnb", "hash", "last", "length")


def prefix_beam_lanes_stepwise(logits: torch.Tensor, logit_len: torch.Tensor,
                               beam_size: int = 16, blank: int = 0, max_len: int = 256,
                               scratch: dict | None = None, trace: torch.Tensor | None = None):
    """CTC prefix beam search without an LM as one launch a frame (K12): the
    (B, K) state lives in device memory between the T launches, which one
    call queues on one stream, each frame's after the last by programmatic
    dependent launch, and each frame writes its (parent, append) pointers; a
    backtrace kernel then reads the best beam's tokens.  ``logits`` (B, T,
    V) are log-softmaxed first.  Returns what ``prefix_beam_fused`` returns.
    A ``scratch`` dict receives the state after the last frame ((B, K) pb,
    pnb, hash, last, length) and every frame's pointers ((B, T, K) parent,
    append), those of ``decoding.prefix_beam.prefix_beam_stepwise_plain``.
    Where a block's working set does not fit its shared memory
    (``study_fits``) it lies in a device scratch, counted as
    ``prefix_beam_stepwise_wide`` (T a call, as the shared form).
    ``trace``, a (T, 9) int64 tensor on the card, receives block 0's clocks
    of each frame."""
    K, L = beam_size, max_len
    logp, lens = _study_inputs("prefix_beam_stepwise", logits, logit_len, blank, K, L)
    if logp.device.type == "cpu":
        if scratch is not None:
            scratch.update(plain.prefix_beam_stepwise_plain(logp, lens, K, L))
        return plain.beam_scan_plain(logp, lens, K, L)
    B, T, V = logp.shape
    dev = logp.device
    _trace_check("prefix_beam_stepwise", trace, T, 9, dev)
    work = None if study_fits(K, V) else _scratch(B, step_bytes(K, V), dev)
    name = "prefix_beam_stepwise" + ("_wide" if work is not None else "")
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    state = {f: torch.empty((B, K), **(f32 if f in ("pb", "pnb") else i32)) for f in _FIELDS}
    parents = torch.empty((B, T, K), **i32)
    appends = torch.empty_like(parents)
    tokens, lengths, scores = _outputs(B, L, dev)
    lib = build.load("prefix_beam_study", _STUDY_SIGNATURES)
    build.check(lib.prefix_beam_stepwise(
        logp.data_ptr(), lens.data_ptr(), *(state[f].data_ptr() for f in _FIELDS),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, L, _ptr(work), _ptr(trace),
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += T
    if scratch is not None:
        scratch.update(state, parent=parents, append=appends)
    return tokens, lengths, scores
