"""CTC prefix beam search on the card: the kernels of ``csrc/prefix_beam.cu``.

Counterparts of ``pytorch_asr_tpu/ops/beam_pallas.py``'s
``prefix_beam_fused_lanes`` (K7, all chars) and
``prefix_beam_fused_lanes_topa`` (K8, each frame's top-A chars), both with an
optional dense n-gram table (``prefix_beam``), and of
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
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_asr_tpu_torch.decoding import prefix_beam as plain
from pytorch_asr_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"prefix_beam": [_P] * 10 + [_I] * 7 + [_F, _F, _P],
               "prefix_beam_rnn": [_P] * 5 + [_I] * 3 + [_P] * 5 + [_I] * 6 + [_F, _F, _P, _P],
               "merge_topk": [_P] * 22 + [_I] * 4 + [_P]}
_STUDY_SIGNATURES = {"prefix_beam_fused": [_P] * 5 + [_I] * 5 + [_P],
                     "prefix_beam_stepwise": [_P] * 12 + [_I] * 5 + [_P]}
MAX_SMEM = 232448    # the dynamic shared memory a Hopper block may use
MAX_BEAM = 1024      # picks are held one a thread
MAX_LM_LAYERS = 8    # the kernel's RnnLm holds this many layers' pointers


def smem_bytes(K: int, C: int, V: int) -> int:
    """Shared memory of one K7/K8 block, as ``csrc/prefix_beam.cu`` lays it out."""
    return 72 * K + 17 * K * C + 8 * V + 512


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


def merge_smem_bytes(Ks: int, nb: int) -> int:
    """Shared memory of one K10 block, as ``csrc/prefix_beam.cu`` lays it out."""
    N = Ks + Ks * nb
    return 8 * N + 512 + 12 * Ks + 5 * Ks * nb


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
    if not 1 <= K <= MAX_BEAM or L < 0 or C < 1:
        raise ValueError(f"prefix_beam: beam_size {K} must be in 1..{MAX_BEAM}, "
                         f"max_len {L} >= 0, lanes {C} >= 1")
    need = smem_bytes(K, C, V)
    if need > MAX_SMEM:
        raise ValueError(f"prefix_beam: K*C = {K}*{C} candidate lanes need {need} bytes of "
                         f"shared memory, more than a block's {MAX_SMEM}")
    return C


def _lm_tensors(rnn_lm, h0, c0, lmp0, V: int) -> dict:
    """K9's LM inputs in the order the kernel takes them, each with the
    shape it must have."""
    cfg = rnn_lm.cfg
    nl, E, H = cfg.num_layers, cfg.embed_dim, cfg.hidden_dim
    out = {"embed": (rnn_lm.embed, (V, E)), "w_out": (rnn_lm.w_out, (H, V)),
           "b_out": (rnn_lm.b_out, (V,)), "h0": (h0, (nl, H)), "c0": (c0, (nl, H)),
           "lmp0": (lmp0, (V,))}
    for kind in ("wx", "wh", "b"):
        for l in range(nl):
            shape = {"wx": (E if l == 0 else H, 4 * H), "wh": (H, 4 * H), "b": (4 * H,)}[kind]
            out[f"lstm{l}_{kind}"] = (getattr(rnn_lm, f"lstm{l}_{kind}"), shape)
    return out


def prefix_beam(logp: torch.Tensor, logit_len: torch.Tensor, beam_size: int, max_len: int,
                lm_table: torch.Tensor | None = None, lm_alpha: float = 0.0,
                lm_beta: float = 0.0, top_val: torch.Tensor | None = None,
                top_idx: torch.Tensor | None = None):
    """Prefix beam search over log-probs ``logp`` (B, T, V) float32 with
    lengths ``logit_len`` (B,) int32 and, optionally, a dense LM table
    (n_ctx, V) float32 fused as ``lm_alpha * row + lm_beta`` a char.  With
    ``top_val``/``top_idx`` (B, T, A) the extensions are each frame's top-A
    chars (K8), else all chars (K7).  Returns (tokens (B, max_len) int32,
    lengths (B,) int32, scores (B,) float32) of the best beam of each row."""
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, logit_len, beam_size, max_len, lm_table, lm_alpha,
                                     lm_beta, top_val, top_idx)
    B, T, V = logp.shape
    K, L = beam_size, max_len
    C = _check(logp, logit_len, lm_table, top_val, top_idx, K, L)
    dev = logp.device
    parents = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    appends = torch.empty_like(parents)
    tokens = torch.empty((B, L), dtype=torch.int32, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = build.load("prefix_beam", _SIGNATURES)
    name = "prefix_beam_topa" if top_idx is not None else "prefix_beam"
    build.check(lib.prefix_beam(
        logp.data_ptr(), ptr(top_val), ptr(top_idx), logit_len.data_ptr(), ptr(lm_table),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, C, L, lm_table.shape[0] if lm_table is not None else 1,
        lm_alpha, lm_beta, torch.cuda.current_stream(dev).cuda_stream), name)
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
    int32, scores (B,) float32) of the best beam of each row.  Each block
    keeps its beams' LM state in shared memory, or, where that does not fit
    beside the search, in a device scratch this wrapper allocates; it raises
    ``ValueError`` only when the LM step's packed inputs, K x (max(E, H) + H)
    floats, do not fit a block's shared memory either."""
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, logit_len, beam_size, max_len, None, lm_alpha,
                                     lm_beta, top_val, top_idx, rnn_lm=rnn_lm,
                                     lm_state=(h0, c0, lmp0))
    B, T, V = logp.shape
    K, L = beam_size, max_len
    cfg = rnn_lm.cfg
    nl, E, H = cfg.num_layers, cfg.embed_dim, cfg.hidden_dim
    lm = _lm_tensors(rnn_lm, h0, c0, lmp0, V)
    C = _check(logp, logit_len, None, top_val, top_idx, K, L, lm)
    if not 1 <= nl <= MAX_LM_LAYERS:
        raise ValueError(f"prefix_beam_rnn: {nl} LM layers; the kernel takes 1..{MAX_LM_LAYERS}")
    dev = logp.device
    lm_state = None
    if rnn_smem_bytes(K, C, V, nl, E, H) > MAX_SMEM:
        need = rnn_smem_bytes(K, C, V, nl, E, H, state_in_smem=False)
        if need > MAX_SMEM:
            raise ValueError(f"prefix_beam_rnn: beam {K} with an LM of E {E}, H {H} needs "
                             f"{need} bytes of shared memory for the search and the LM "
                             f"step's packed inputs, more than a block's {MAX_SMEM}")
        lm_state = torch.empty((B, lm_state_floats(K, V, nl, H)), dtype=torch.float32,
                               device=dev)
    parents = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    appends = torch.empty_like(parents)
    tokens = torch.empty((B, L), dtype=torch.int32, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B,), dtype=torch.float32, device=dev)
    weights = (_P * len(lm))(*(t.data_ptr() for t, _ in lm.values()))
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = build.load("prefix_beam", _SIGNATURES)
    name = "prefix_beam_rnn_topa" if top_idx is not None else "prefix_beam_rnn"
    build.check(lib.prefix_beam_rnn(
        logp.data_ptr(), ptr(top_val), ptr(top_idx), logit_len.data_ptr(), weights, nl, E, H,
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, C, L, lm_alpha, lm_beta, ptr(lm_state),
        torch.cuda.current_stream(dev).cuda_stream), name)
    build.LAUNCHES[name] += 1
    return tokens, lengths, scores


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


def merge_topk(stay: dict, ext: dict, K: int):
    """One frame's merge and top-K of the beam-sharded search: absorb each
    extension into the alive stay of the same prefix, keep the K best of the
    stays and the extension lanes (stays first on ties, then the lower flat
    index), and pick every field.  ``stay`` holds (B, Ks) fields pb, pnb, lm
    (float32), hash, last, parent, ctx (int32); ``ext`` (B, Ks, V-1) fields
    pnb, lm, hash, parent, append, ctx, lane (k, c-1) beam k's extension by
    char c (``_build_candidates``' layout), whose last char is ``append``.
    Returns (score (B, K), fields: pb, pnb, lm, hash, last, parent, append,
    ctx (B, K)), the contract of ``decoding/prefix_beam.py::_merge_topk``."""
    if stay["pb"].device.type == "cpu":
        return plain._merge_topk(stay, ext, K)
    B, Ks = stay["pb"].shape
    nb = ext["pnb"].shape[2]
    if stay["ctx"].dim() != 2:
        raise ValueError("merge_topk: a ctx window (the hashed LM's) is not taken: ctx must "
                         "be (B, Ks)")
    ins = []
    for part, name, dtype in _MERGE_IN:
        t = (stay if part == "stay" else ext)[name]
        shape = (B, Ks) if part == "stay" else (B, Ks, nb)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"merge_topk: {part}[{name!r}] must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != stay["pb"].device or not t.is_contiguous():
            raise ValueError("merge_topk: all inputs must be contiguous on one CUDA device")
        ins.append(t)
    if not 1 <= K <= Ks + Ks * nb or Ks > MAX_BEAM:
        raise ValueError(f"merge_topk: K {K} must be in 1..{Ks + Ks * nb} candidates and "
                         f"Ks {Ks} at most {MAX_BEAM}")
    if merge_smem_bytes(Ks, nb) > MAX_SMEM:
        raise ValueError(f"merge_topk: {Ks} x {nb} lanes need {merge_smem_bytes(Ks, nb)} bytes "
                         f"of shared memory, more than a block's {MAX_SMEM}")
    dev = stay["pb"].device
    score = torch.empty((B, K), dtype=torch.float32, device=dev)
    out = {name: torch.empty((B, K), dtype=dtype, device=dev) for name, dtype in _MERGE_OUT}
    lib = build.load("prefix_beam", _SIGNATURES)
    build.check(lib.merge_topk(
        *(t.data_ptr() for t in ins), score.data_ptr(), *(t.data_ptr() for t in out.values()),
        B, Ks, nb, K, torch.cuda.current_stream(dev).cuda_stream), "merge_topk")
    build.LAUNCHES["merge_topk"] += 1
    return score, out


# ------------------------------------------------- K12, K13: csrc/prefix_beam_study.cu


def _frame_smem_bytes(K: int, V: int) -> int:
    """One frame's scratch in ``csrc/prefix_beam_study.cu``: keys, warp
    maxima, candidates and the row, absorbed flags."""
    KC = K * (V - 1)
    return 8 * (K + KC) + 512 + 4 * (2 * K + KC + V) + KC


def fused_smem_bytes(K: int, V: int, L: int) -> int:
    """Shared memory of one K13 block: the frame's, the double-buffered beam
    fields and token buffers (2, K, L) int32, and each pick's parent,
    append and parent length."""
    return _frame_smem_bytes(K, V) + 4 * (13 * K + 2 * K * L)


def step_smem_bytes(K: int, V: int) -> int:
    """Shared memory of one K12 block: the frame's and its row's state."""
    return _frame_smem_bytes(K, V) + 4 * 5 * K


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
    B, T, V = logp.shape
    if tuple(lens.shape) != (B,) or lens.device != logp.device:
        raise ValueError(f"{name}: logit_len must be ({B},) on {logp.device}")
    if V < 2 or not 1 <= K <= MAX_BEAM or L < 0:
        raise ValueError(f"{name}: vocabulary {V} >= 2, beam_size {K} in 1..{MAX_BEAM} and "
                         f"max_len {L} >= 0 are needed")
    need = fused_smem_bytes(K, V, L) if name == "prefix_beam_fused" else step_smem_bytes(K, V)
    if need > MAX_SMEM:
        raise ValueError(f"{name}: beam {K} x vocabulary {V} (max_len {L}) needs {need} bytes "
                         f"of shared memory, more than a block's {MAX_SMEM}")


def _outputs(B: int, L: int, dev):
    return (torch.empty((B, L), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev))


def prefix_beam_fused(logits: torch.Tensor, logit_len: torch.Tensor, beam_size: int = 16,
                      blank: int = 0, max_len: int = 256):
    """CTC prefix beam search without an LM in one launch, each beam's
    tokens carried in the block (K13).  ``logits`` (B, T, V) are
    log-softmaxed first.  Returns (tokens (B, max_len) int32, lengths (B,)
    int32, scores (B,) float32) of the best beam of each row, those of
    ``decoding.prefix_beam.beam_scan_plain``."""
    K, L = beam_size, max_len
    logp, lens = _study_inputs("prefix_beam_fused", logits, logit_len, blank, K, L)
    if logp.device.type == "cpu":
        return plain.beam_scan_plain(logp, lens, K, L)
    B, T, V = logp.shape
    tokens, lengths, scores = _outputs(B, L, logp.device)
    lib = build.load("prefix_beam_study", _STUDY_SIGNATURES)
    build.check(lib.prefix_beam_fused(
        logp.data_ptr(), lens.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, L, torch.cuda.current_stream(logp.device).cuda_stream),
        "prefix_beam_fused")
    build.LAUNCHES["prefix_beam_fused"] += 1
    return tokens, lengths, scores


_FIELDS = ("pb", "pnb", "hash", "last", "length")


def prefix_beam_lanes_stepwise(logits: torch.Tensor, logit_len: torch.Tensor,
                               beam_size: int = 16, blank: int = 0, max_len: int = 256,
                               scratch: dict | None = None):
    """CTC prefix beam search without an LM as one launch a frame (K12): the
    (B, K) state lives in device memory between the T launches, which one
    call queues on one stream, and each frame writes its (parent, append)
    pointers; a backtrace kernel then reads the best beam's tokens.
    ``logits`` (B, T, V) are log-softmaxed first.  Returns what
    ``prefix_beam_fused`` returns.  A ``scratch`` dict receives the state
    after the last frame ((B, K) pb, pnb, hash, last, length) and every
    frame's pointers ((B, T, K) parent, append), those of
    ``decoding.prefix_beam.prefix_beam_stepwise_plain``."""
    K, L = beam_size, max_len
    logp, lens = _study_inputs("prefix_beam_stepwise", logits, logit_len, blank, K, L)
    if logp.device.type == "cpu":
        if scratch is not None:
            scratch.update(plain.prefix_beam_stepwise_plain(logp, lens, K, L))
        return plain.beam_scan_plain(logp, lens, K, L)
    B, T, V = logp.shape
    dev = logp.device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    state = {f: torch.empty((B, K), **(f32 if f in ("pb", "pnb") else i32)) for f in _FIELDS}
    parents = torch.empty((B, T, K), **i32)
    appends = torch.empty_like(parents)
    tokens, lengths, scores = _outputs(B, L, dev)
    lib = build.load("prefix_beam_study", _STUDY_SIGNATURES)
    build.check(lib.prefix_beam_stepwise(
        logp.data_ptr(), lens.data_ptr(), *(state[f].data_ptr() for f in _FIELDS),
        parents.data_ptr(), appends.data_ptr(), tokens.data_ptr(), lengths.data_ptr(),
        scores.data_ptr(), B, T, V, K, L, torch.cuda.current_stream(dev).cuda_stream),
        "prefix_beam_stepwise")
    build.LAUNCHES["prefix_beam_stepwise"] += T
    if scratch is not None:
        scratch.update(state, parent=parents, append=appends)
    return tokens, lengths, scores
