"""The beam kernels' frame selection (``csrc/prefix_beam.cu::search_frame``,
and its copy in ``csrc/prefix_beam_study.cu``:
``warp_sort_desc`` and its register form, the merge tree, and for larger
beams theta, ``count_above`` and the rank loop) emulated in numpy, warp for
warp, against a stable descending sort of the candidates' scores.

The kernel gives each of min(warps, ceil(N / 32)) warps a contiguous
segment of the N = K + K*C candidates, sorts it descending with the flip
form of a bitonic network (keys past the segment count as 0 and their
exchanges are skipped), then for K <= 32 merges the segments' top K in a
tree of bitonic merges; else ranks the first min(K, segment) keys of each
segment that are not below theta (the largest K-th key of a segment) by
counting the keys above them in every segment, a key of rank r < K being
pick r.  The picks
must be the K best candidates in the order the plain search takes them:
higher score first, the lower flat index on ties.  Pure numpy, no device.
"""

from __future__ import annotations

import numpy as np
import pytest

NEG_INF = np.float32(-1.0e30)


def make_keys(scores: np.ndarray) -> np.ndarray:
    """csrc/prefix_beam.cu::make_key of each (score, flat index) as uint64."""
    s = scores.astype(np.float32).copy()
    s[s == 0] = 0.0                                   # -0 ranks as +0
    u = s.view(np.uint32).astype(np.uint64)
    neg = (u & 0x80000000) != 0
    u = np.where(neg, (~u) & 0xFFFFFFFF, u | 0x80000000)
    idx = np.arange(len(s), dtype=np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)


def key_index(key) -> int:
    return int(0xFFFFFFFF - (int(key) & 0xFFFFFFFF))


def warp_sort_desc(seg: np.ndarray) -> np.ndarray:
    """The kernel's warp_sort_desc on one segment: every stage's exchanges
    are disjoint, so a stage runs as one vectorized step."""
    key = seg.copy()
    n = len(key)
    lg = 0
    while (1 << lg) < n:
        lg += 1
    q = np.arange((1 << lg) >> 1)
    for s in range(1, lg + 1):
        base, o = (q >> (s - 1)) << s, q & ((1 << (s - 1)) - 1)
        stages = [(base + o, base + (1 << s) - 1 - o)]
        for e in range(s - 2, -1, -1):
            i = ((q >> e) << (e + 1)) | (q & ((1 << e) - 1))
            stages.append((i, i + (1 << e)))
        for i, j in stages:
            keep = j < n
            i, j = i[keep], j[keep]
            a, b = key[i], key[j]
            swap = b > a
            key[i[swap]], key[j[swap]] = b[swap], a[swap]
    return key


def count_above(s: np.ndarray, n: int, P: int, x) -> int:
    """The kernel's count_above: how many of the descending s[0, n) are
    above x, n <= P (a power of two), by log2(P) + 1 fixed steps."""
    i, step = 0, P
    while step > 0:
        if i + step <= n and s[i + step - 1] > x:
            i += step
        step >>= 1
    return i


def count_above_clamped(s: np.ndarray, n: int, x) -> int:
    """The same count as the kernel's rank loop takes it for at most 32
    keys: six fixed steps whose load index is clamped into the segment."""
    at = 0
    for step in (32, 16, 8, 4, 2, 1):
        y = s[max(min(at + step, n) - 1, 0)] if len(s) else 0
        at += step if at + step <= n and y > x else 0
    return at


def half_clean(c: np.ndarray) -> np.ndarray:
    """The tree's five half-cleaners over a warp's 32 keys: lane l against
    lane l ^ o, the lower lane keeping the larger (o = 16, 8, 4, 2, 1)."""
    v = c.copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        u = v[lanes ^ o]
        v = np.where((lanes & o) == 0, np.maximum(v, u), np.minimum(v, u))
    return v


def merge_tree(tops: list[np.ndarray], K: int) -> np.ndarray:
    """The kernel's merge tree: lists of K keys (0-padded); at each level
    list i takes list i + ceil(m / 2) by a lane-wise max with the other
    reversed and the half-cleaners; returns list 0."""
    lists = [np.concatenate([t, np.zeros(32 - len(t), np.uint64)]) for t in tops]
    m = len(lists)
    while m > 1:
        h = (m + 1) // 2
        for i in range(m - h):
            a = np.where(np.arange(32) < K, lists[i], 0).astype(np.uint64)
            b = np.where(31 - np.arange(32) < K, lists[i + h][::-1], 0).astype(np.uint64)
            lists[i] = half_clean(np.maximum(a, b))
        m = h
    return lists[0][:K]


def select(keys: np.ndarray, K: int, nt: int, literal: bool) -> list[int]:
    """The picks' flat indices in rank order, as the kernel's threads find
    them: segments of 32 where the warps suffice, sorted; for K <= 32 with
    segments of at least K keys the merge tree of their tops; else theta,
    the largest K-th key of a segment that has K, and each key at or above
    theta in the first min(K, seg) of its segment ranked by the count of
    keys above it in every segment (its own included).  ``literal`` counts
    as the kernel does; else vectorized (for the large cases)."""
    N = len(keys)
    nw = min(nt // 32, -(-N // 32))          # segments of 32 where the warps suffice
    seg = -(-N // nw)
    lens = [max(0, min(N, (w + 1) * seg) - w * seg) for w in range(nw)]
    segs = [warp_sort_desc(keys[w * seg: w * seg + lens[w]]) for w in range(nw)]
    for w in range(nw):
        assert np.all(segs[w][:-1] > segs[w][1:])       # descending, keys unique
    if K <= 32 and seg >= K:        # the merge tree, the short last segment 0-padded to K
        tops = [np.concatenate([sg[:K], np.zeros(max(0, K - len(sg)), np.uint64)]) for sg in segs]
        return [key_index(k) for k in merge_tree(tops, K)]
    top = min(K, seg)
    P = 1
    while P < top:
        P <<= 1
    theta = max([segs[o][K - 1] for o in range(nw) if lens[o] >= K], default=0)
    picks = [None] * K
    asc = [segs[o][:min(top, lens[o])][::-1] for o in range(nw)]
    for w in range(nw):
        for p in range(min(top, lens[w])):
            x = segs[w][p]
            if x < theta:
                continue
            if not literal:
                rank = sum(len(a) - int(np.searchsorted(a, x, side="right")) for a in asc)
            elif top <= 32:
                rank = sum(count_above_clamped(segs[o], min(top, lens[o]), x) for o in range(nw))
            else:
                rank = sum(count_above(segs[o], min(top, lens[o]), P, x) for o in range(nw))
            if rank < K:
                assert picks[rank] is None, "two keys took one rank"
                picks[rank] = key_index(x)
    assert all(p is not None for p in picks), "a rank went unfilled"
    return picks


def stable_order(scores: np.ndarray, K: int) -> list[int]:
    """Higher score first, the lower flat index on ties."""
    return list(np.argsort(-scores.astype(np.float64), kind="stable")[:K])


def _scores(rng, K: int, C: int, ties: bool, dead: float) -> np.ndarray:
    """K stays then K*C lanes: random scores, or few distinct values (exact
    ties), with a share ``dead`` of NEG_INF fillers."""
    N = K + K * C
    if ties:
        s = rng.integers(-4, 2, size=N).astype(np.float32)
    else:
        s = (rng.standard_normal(N) * 5).astype(np.float32)
    s[rng.random(N) < dead] = NEG_INF
    return s


@pytest.mark.parametrize("K,C,nt", [
    (16, 31, 512),     # K7 at config 2: 512 candidates, one a lane
    (16, 31, 1024),    # K9's block kernel: 1024 threads, 16 segments of 32
    (16, 8, 160),      # K8's top 8: 144 candidates over 160 threads
    (16, 8, 128),      # fewer threads than candidates: segments of 36
    (8, 31, 256),
    (5, 3, 32),        # one warp, N = 20: a segment shorter than a warp
    (3, 7, 96),        # N = 24 over 3 warps: segments of 8
    (7, 5, 64),        # N = 42 over 2 warps: not a multiple of 32
    (1, 31, 32),       # beam 1
])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dead", [0.0, 0.5])
def test_selection_is_the_stable_descending_order(K, C, nt, ties, dead):
    rng = np.random.default_rng(K * 1000 + C * 10 + nt + ties)
    scores = _scores(rng, K, C, ties, dead)
    assert select(make_keys(scores), K, nt, literal=True) == stable_order(scores, K)


@pytest.mark.parametrize("K,V,nt", [
    (16, 31, 512),     # K12/K13 at K7's row shape: 496 candidates, segments of 31
    (16, 32, 512),     # the benchmark scripts' V 32: 512 candidates, segments of 32
    (16, 31, 480),     # the thread count before: 15 warps, segments of 34 (in place)
])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dead", [0.0, 0.5])
def test_selection_at_the_study_lanes_layout(K, V, nt, ties, dead):
    """csrc/prefix_beam_study.cu's frame: the plain search's lanes, V - 1 a
    beam (no blank lane), so N = K + K (V - 1) candidates."""
    rng = np.random.default_rng(K * 1000 + V * 10 + nt + ties)
    scores = _scores(rng, K, V - 1, ties, dead)
    assert select(make_keys(scores), K, nt, literal=True) == stable_order(scores, K)


@pytest.mark.parametrize("K,C,nt", [(400, 31, 1024), (1024, 8, 1024), (1100, 4, 1024)])
def test_selection_at_large_beams(K, C, nt):
    """Beam 400 over the chars, 1024 over the top 8 and 1100 over the top 4
    (more beams than threads): segments longer than K or shorter."""
    rng = np.random.default_rng(K + C)
    scores = _scores(rng, K, C, ties=True, dead=0.3)
    assert select(make_keys(scores), K, nt, literal=False) == stable_order(scores, K)


def test_all_dead_but_one_and_negative_zero():
    """Every candidate a NEG_INF filler but one: the fillers follow it in
    index order; -0 and +0 tie and go by index."""
    K, C = 16, 31
    scores = np.full(K + K * C, NEG_INF, np.float32)
    scores[200] = 1.0
    scores[7], scores[3] = np.float32(-0.0), np.float32(0.0)
    assert select(make_keys(scores), K, 512, literal=True) == stable_order(scores, K)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 32, 33, 100, 288])
def test_warp_sort_sorts_any_length(n):
    rng = np.random.default_rng(n)
    keys = make_keys((rng.standard_normal(n) * 3).astype(np.float32))
    assert list(warp_sort_desc(keys)) == sorted(keys, reverse=True)


def test_count_above_counts_the_keys_above():
    keys = np.array(sorted(make_keys(np.arange(40, dtype=np.float32)), reverse=True))
    for n in (0, 1, 4, 7, 32, 40):
        for x in keys[::3]:
            want = int(np.sum(keys[:n] > x))
            assert count_above(keys, n, 64, x) == want
            if n <= 32:
                assert count_above_clamped(keys, n, x) == want


@pytest.mark.parametrize("K,C,nt", [(40, 31, 1024), (64, 3, 256), (32, 40, 1024)])
def test_selection_past_32_a_segment_literal(K, C, nt):
    """K past 32 with segments longer than 32 (the ranks), and K 32 over
    41-key segments sorted in shared memory (the tree)."""
    rng = np.random.default_rng(K)
    scores = _scores(rng, K, C, ties=True, dead=0.2)
    assert select(make_keys(scores), K, nt, literal=True) == stable_order(scores, K)


# ------------------------------------------- K10: csrc/prefix_beam.cu::merge_topk_kernel


def merge_threads(Ks: int, nb: int) -> int:
    """K10's block (csrc/prefix_beam.cu::search_threads(Ks, nb)): a thread a
    candidate, at least Ks kp for the absorb's tests (Ks <= 32), to 32, at
    most 1024."""
    n = Ks + Ks * nb
    kp = 1
    while kp < Ks:
        kp <<= 1
    if kp <= 32 and Ks * kp > n:
        n = Ks * kp
    return 1024 if n >= 1024 else -(-n // 32) * 32


def _merge_candidates(rng, Ks: int, nb: int, ties: bool, dead: float):
    """One row of gathered candidates in the plain merge's layout: Ks stays,
    lane (k, c - 1) beam k's extension by char c; stays' parents are their
    indices, lanes' (k, c); hashes drawn until no lane would be absorbed."""
    import torch

    def draw(shape):
        if ties:
            return torch.from_numpy(rng.integers(-4, 2, size=shape).astype(np.float32))
        return torch.from_numpy((rng.standard_normal(shape) * 5).astype(np.float32))

    stay = {"pb": draw((1, Ks)), "pnb": draw((1, Ks)), "lm": draw((1, Ks))}
    for f in ("pb", "pnb"):
        stay[f][torch.from_numpy(rng.random((1, Ks)) < dead)] = float(NEG_INF)
    while True:
        h = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(1, Ks)).astype(np.int64)
        cmat = (h[:, None, :] - 1000003 * h[:, :, None]) % 2 ** 32
        if not ((cmat >= 1) & (cmat <= nb)).any():
            break
    idx = torch.arange(Ks, dtype=torch.int32)[None]
    stay.update(hash=torch.from_numpy(h.astype(np.int32)), last=idx.clone(), parent=idx.clone(),
                append=torch.full((1, Ks), -1, dtype=torch.int32), ctx=idx.clone())
    k = torch.arange(Ks, dtype=torch.int32)[None, :, None].expand(1, Ks, nb).contiguous()
    c = torch.arange(1, nb + 1, dtype=torch.int32)[None, None, :].expand(1, Ks, nb).contiguous()
    ext = {"pnb": draw((1, Ks, nb)), "lm": draw((1, Ks, nb)), "hash": k * 1000 + c,
           "parent": k, "append": c, "last": c, "ctx": k}
    ext["pnb"][torch.from_numpy(rng.random((1, Ks, nb)) < dead)] = float(NEG_INF)
    return stay, ext


@pytest.mark.parametrize("Ks,nb,nt", [
    (16, 30, 512),     # the sharded decode at config 2: N 496, segments of 31
    (16, 31, 512),     # N 512, segments of 32
    (64, 30, 1024),    # K past 32: 32 segments of 62, the ranks
    (4, 30, 128),      # N 124 over 4 warps
])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dead", [0.0, 0.5])
def test_merge_selection_is_the_plain_merges_order(Ks, nb, nt, ties, dead):
    """K10's selection at its lane layout, emulated warp for warp on its
    block's thread count, picks the plain ``_merge_topk``'s candidates in
    its order (its stable descending sort), dead fillers included."""
    import torch

    from pytorch_asr_tpu_torch.decoding import prefix_beam as pb

    assert merge_threads(Ks, nb) == nt
    rng = np.random.default_rng(Ks * 100 + nb + 7 * ties + int(10 * dead))
    stay, ext = _merge_candidates(rng, Ks, nb, ties, dead)
    score, fields = pb._merge_topk(stay, ext, Ks)
    want = [int(p) if int(a) < 0 else Ks + int(p) * nb + int(a) - 1
            for p, a in zip(fields["parent"][0], fields["append"][0])]
    # The kernel's candidate scores: the plain merge's operations with no match.
    stay_pnb = pb._lse(stay["pnb"], torch.full_like(stay["pnb"], float(NEG_INF)))
    flat = torch.cat([pb._lse(stay["pb"], stay_pnb) + stay["lm"],
                      (ext["pnb"] + ext["lm"]).reshape(1, -1)], dim=1)[0].numpy()
    got = select(make_keys(flat), Ks, nt, literal=True)
    assert got == want
    assert got == stable_order(flat, Ks)
    assert np.array_equal(flat[got], score[0].numpy())
