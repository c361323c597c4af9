"""The beam search past a kernel block's shared memory: the rule
``ops/beam_cuda.py::fits`` and the scratch layout ``scratch_bytes`` (pure
Python), and the search at a beam no block's shared memory takes, held to
the JAX package's scan on the same numpy-seeded logits.

On the card the wrappers launch the kernel with its working set in a
device scratch where ``fits`` is False, counted as ``prefix_beam_wide``
(``tests/test_torch_kernels_cuda.py`` holds it bit for bit to the plain
search there); here, on CPU tensors, the plain search runs, so its result
at such a beam is what the card must return.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_asr_tpu.decoding.prefix_beam import prefix_beam_search as jax_search
from pytorch_asr_tpu_torch.decoding import prefix_beam as pb
from pytorch_asr_tpu_torch.ops import beam_cuda, build

# As tests/test_torch_prefix_beam.py: float32 log-space sums, XLA's and
# torch's exp/log1p a few ulp apart.
SCORE_RTOL = 1e-5
CHARS = 31                     # the char vocabulary
LM_DEFAULT = (2, 128, 256)     # RNNLMConfig's layers, E, H
LM_H512 = (2, 128, 512)


@pytest.mark.parametrize("K,C,lm,want", [
    (16, CHARS, None, True),        # K7 at config 2's beam
    (386, CHARS, None, True),       # the widest K7 block over the chars
    (387, CHARS, None, False),      # 232,573 bytes of shared memory
    (400, CHARS, None, False),
    (1024, 8, None, True),          # K8's top 8 at the most beams a block holds
    (1025, 8, None, False),         # more beams than threads
    (16, CHARS, LM_DEFAULT, True),  # K9 at config 2
    (32, CHARS, LM_DEFAULT, True),  # K9 with its state in a device scratch
    (16, CHARS, LM_H512, True),
    (64, CHARS, LM_H512, False),    # the LM step's packed inputs alone pass a block
    (16, CHARS, (9, 128, 256), True),   # any number of layers: the state lies in a scratch
])
def test_fits_rule(K, C, lm, want):
    assert beam_cuda.fits(K, C, CHARS, lm) is want


def test_fits_agrees_with_the_shared_memory_the_blocks_need():
    for K in range(1, 1025, 7):
        assert beam_cuda.fits(K, CHARS, CHARS) == (
            beam_cuda.smem_bytes(K, CHARS, CHARS) <= beam_cuda.MAX_SMEM)
        assert beam_cuda.fits(K, CHARS, CHARS, LM_H512) == (beam_cuda.rnn_smem_bytes(
            K, CHARS, CHARS, *LM_H512, state_in_smem=False) <= beam_cuda.MAX_SMEM)


@pytest.mark.parametrize("K,C,lm", [(16, CHARS, None), (400, CHARS, None), (1100, 4, None),
                                    (16, CHARS, LM_DEFAULT), (64, CHARS, LM_H512),
                                    (64, 8, LM_H512)])
def test_scratch_slice_holds_the_working_set_and_the_picks(K, C, lm):
    """A block's slice of the scratch: the working set as shared memory
    lays it out (K9's with its LM state beside the search), to a 16-byte
    boundary; the frame's picks need no room of their own there (each is
    taken by the thread that holds it), and every slice starts 16-byte
    aligned, as the kernel's float4 and 8-byte keys need."""
    work = (beam_cuda.smem_bytes(K, C, CHARS) if lm is None
            else beam_cuda.rnn_smem_bytes(K, C, CHARS, *lm))
    got = beam_cuda.scratch_bytes(K, C, CHARS, lm)
    assert got % 16 == 0
    assert work <= got < work + 16


@pytest.mark.parametrize("K,A", [(400, 0), (1100, 4)])
def test_search_past_the_block_matches_jax_scan(K, A):
    """Beam 400 over the char vocab, and beam 1100 (more than a block's
    threads) over each frame's top 4, two rows of at most 16 frames: the
    beams fill after a few frames (31^2 > 400, 4^6 > 1100 prefixes)."""
    B, T, L = 2, 16, 12
    assert not beam_cuda.fits(K, A or CHARS, CHARS)
    rng = np.random.default_rng(40)
    logits = (rng.standard_normal((B, T, CHARS)) * 2).astype(np.float32)
    lens = np.array([T, 11], np.int32)
    build.reset_launches()
    got = pb.prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens), beam_size=K,
                                max_len=L, ext_top_a=A)
    assert not any(build.LAUNCHES.values())   # CPU tensors: nothing launched, nothing counted
    want = jax_search(jnp.asarray(logits), jnp.asarray(lens), beam_size=K, max_len=L,
                      ext_top_a=A, use_fused=False)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=SCORE_RTOL)
