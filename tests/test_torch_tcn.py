"""The port's TCN block and config-3 model vs the JAX package, on the CPU.

The plain versions that the K5 and K6 wrappers take for CPU tensors are held
against the JAX package's XLA block (``TCNBlock._xla_path``) and its Pallas
kernels in interpret mode (``tcn_block_pallas``, ``_train_fwd_impl``, and
``jax.grad`` through ``tcn_block_train``'s custom VJP), at T = 300 frames so
the JAX side crosses its 256-frame ``T_BLOCK``.  Then the whole
``tcn_ctc_devclean`` model at a small size, loaded from a JAX tree through
``weights.load_jax_params``, one float32 train step against JAX's, and both
CLIs.  Inputs are made with numpy from a seed.  The kernels themselves are
held against these plain versions in test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.models.asr_model import ASRModel as JaxASRModel
from pytorch_asr_tpu.models.encoder_tcn import TCNBlock as JaxTCNBlock
from pytorch_asr_tpu.ops import runtime as jax_runtime
from pytorch_asr_tpu.ops.dilated_conv_pallas import (
    _train_fwd_impl,
    tcn_block_pallas,
    tcn_block_train as jax_tcn_block_train,
)
from pytorch_asr_tpu.training import state as jax_state
from pytorch_asr_tpu_torch import decode, evaluate, train, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.models.asr_model import ASRModel
from pytorch_asr_tpu_torch.models.encoder_tcn import TCNBlock
from pytorch_asr_tpu_torch.ops import build, tcn_cuda
from pytorch_asr_tpu_torch.training import state as port_state

NAMES = ("ln_scale", "ln_bias", "w_conv", "b_conv", "w_point", "b_point")
# The JAX package holds its Pallas block to a Precision.HIGHEST reference at
# this bound (tests/test_dilated_conv_pallas.py); float32 on both sides here.
BLOCK_TOL = 2e-4
# Gradients, relative to each tensor's largest entry, as the JAX package
# holds its custom VJP to jax.grad of the reference.
GRAD_TOL = 5e-4
SMALL = {"model.encoder.channels": "32", "model.encoder.num_blocks": "5",
         "model.encoder.dropout": "0.0", "model.compute_dtype": "float32"}
# Float32 model logits: the frontends' FFTs, the stem conv and the block
# products sum in other orders (4.6e-6 measured against XLA); against
# interpret mode the Pallas STFT's bf16x3 products move log-mel by up to
# 2e-3 (tests/test_stft_pallas.py), 4.7e-5 on these logits.
MODEL_TOL = 1e-4
# bf16 compute against interpret mode: the stem conv, each block's output
# and the final LayerNorm round to bf16 on both sides, and a value whose two
# float32 sources straddle a rounding boundary lands one bf16 step apart
# (2^-7 relative).  Measured 0.0195 on logits of up to 3.98 (0.5%), held to
# 1.5% of the largest logit.
BF16_TOL = 1.5e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block_case(seed, B=2, T=300, C=32, K=5):
    """x with the last frames of row 1 zero (padding), and block weights with
    LayerNorm scales near 1 and nonzero biases."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    lengths = np.array([T] + [T - 37] * (B - 1), np.int32)
    for b, n in enumerate(lengths):
        x[b, n:] = 0.0
    p = [1.0 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C),
         rng.standard_normal((K, C, 2 * C)) * 0.05, 0.1 * rng.standard_normal(2 * C),
         rng.standard_normal((C, C)) * 0.05, 0.1 * rng.standard_normal(C)]
    return x, lengths, [a.astype(np.float32) for a in p]


def _port_block(p, dilation, dropout=0.0):
    block = TCNBlock(p[3].shape[0] // 2, p[2].shape[0], dilation, dropout)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in zip(NAMES, p)})
    return block


def _jax_block_out(x, lengths, p, dilation):
    block = JaxTCNBlock(channels=x.shape[2], kernel_size=p[2].shape[0], dilation=dilation,
                        dropout=0.0)
    return np.asarray(block.apply({"params": dict(zip(NAMES, map(jnp.asarray, p)))},
                                  jnp.asarray(x), jnp.asarray(lengths), False))


@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
def test_block_matches_jax_xla(dilation):
    """The port's block (K5's plain version, then the mask) against the flax
    block's XLA path, padded frames included."""
    x, lengths, p = _block_case(dilation)
    with torch.no_grad():
        ours = _port_block(p, dilation)(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(ours, _jax_block_out(x, lengths, p, dilation),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("dilation", [1, 4, 16])
def test_block_plain_matches_pallas_interpret(dilation):
    x, _, p = _block_case(10 + dilation)
    ref = tcn_block_pallas(jnp.asarray(x), *map(jnp.asarray, p), dilation=dilation,
                           interpret=True)
    ours = tcn_cuda.tcn_block(torch.from_numpy(x), *map(torch.from_numpy, p), dilation)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("dilation", [2, 8])
def test_train_forward_matches_pallas_interpret(dilation):
    """K6's forward outputs: the body y (no residual) and xn."""
    x, _, p = _block_case(20 + dilation)
    y_ref, xn_ref = _train_fwd_impl(jnp.asarray(x), *map(jnp.asarray, p), dilation, 1e-6, True)
    y, xn = tcn_cuda.tcn_block_train_fwd(torch.from_numpy(x), *map(torch.from_numpy, p),
                                         dilation)
    T = x.shape[1]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xn_ref)[:, :T], rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


def _jax_grads(x, p, w, dilation, interpret):
    def loss(*args):
        if interpret:
            return jnp.sum(jax_tcn_block_train(*args, dilation) * w)
        xx, s, b, wc, bc, wp, bp = args
        mu = jnp.mean(xx, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(xx - mu), axis=-1, keepdims=True)
        y = (xx - mu) * jax.lax.rsqrt(var + 1e-6) * s + b
        y = jax.lax.conv_general_dilated(
            y, wc, window_strides=(1,), padding="SAME", rhs_dilation=(dilation,),
            dimension_numbers=("NWC", "WIO", "NWC"),
            precision=jax.lax.Precision.HIGHEST) + bc
        lin, gate = jnp.split(y, 2, axis=-1)
        return jnp.sum(((lin * jax.nn.sigmoid(gate)) @ wp + bp) * w)

    jax_runtime.force_interpret(True if interpret else None)
    try:
        grads = jax.grad(loss, argnums=tuple(range(7)))(jnp.asarray(x), *map(jnp.asarray, p))
    finally:
        jax_runtime.force_interpret(None)
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dilation", [1, 4, 16])
def test_train_grads_match_jax(dilation, ref):
    """The seven gradients of TCNBlockTrain (K6's plain backward plus the
    LayerNorm backward) against jax.grad through the JAX custom VJP in
    interpret mode, and through the XLA reference."""
    x, _, p = _block_case(30 + dilation)
    w = np.random.default_rng(40 + dilation).standard_normal(x.shape).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, *p)]
    (tcn_cuda.tcn_block_train(*ts, dilation) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("x",) + NAMES, ts, _jax_grads(x, p, w, dilation,
                                                        ref == "pallas_interpret")):
        scale = max(float(np.abs(g).max()), 1.0)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_padded_frames_feed_layernorm_bias():
    """Parity trap: a frame past an utterance's length is 0, but its
    LayerNorm output is ln_bias, and the last valid frames' taps read it.
    The port, like JAX, zeroes xn only outside [0, T) of the padded batch, so
    the last frames differ from a run on the utterance alone, and the rest
    do not."""
    d = 4
    x, lengths, p = _block_case(50, B=2, T=64)
    n = int(lengths[1])
    y, xn = tcn_cuda.tcn_block_train_fwd_plain(torch.from_numpy(x), *map(torch.from_numpy, p), d)
    torch.testing.assert_close(xn[1, n:], torch.from_numpy(p[1]).expand(64 - n, -1))
    with torch.no_grad():
        block = _port_block(p, d)
        padded = block(torch.from_numpy(x[1:]), torch.from_numpy(lengths[1:]))[0, :n].numpy()
        alone = block(torch.from_numpy(x[1:, :n]), torch.from_numpy(lengths[1:]))[0].numpy()
    np.testing.assert_allclose(padded, _jax_block_out(x, lengths, p, d)[1, :n],
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    reach = d * (p[2].shape[0] // 2)                 # frames whose taps cross n
    np.testing.assert_allclose(padded[: n - reach], alone[: n - reach], rtol=1e-5, atol=1e-5)
    assert np.abs(padded[n - reach:] - alone[n - reach:]).max() > 20 * BLOCK_TOL


def test_dilation_beyond_the_halo_is_refused():
    x, _, p = _block_case(60, B=1, T=16)
    args = (torch.from_numpy(x), *map(torch.from_numpy, p))
    for fn in (tcn_cuda.tcn_block, tcn_cuda.tcn_block_train_fwd):
        with pytest.raises(ValueError, match="halo"):
            fn(*args, 32)
    with pytest.raises(ValueError, match="halo"):
        tcn_cuda.tcn_block_bwd(args[0], args[0], args[3], args[4], args[5], 17)
    with pytest.raises(ValueError, match="halo"):
        tcn_block_pallas(jnp.asarray(x), *map(jnp.asarray, p), dilation=32, interpret=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_mode_picks_the_training_pair_and_counts_nothing_on_cpu(dtype):
    """Inference with gradients runs K6's pair, since K5 has no backward,
    and adds the residual in float32 as K5 does: the same bits as without
    gradients, in bf16 too.  On the CPU both take plain versions and count
    no launch."""
    x, lengths, p = _block_case(70, T=40)
    block = _port_block(p, 2)
    xt, lt = torch.from_numpy(x).to(dtype), torch.from_numpy(lengths)
    build.reset_launches()
    with torch.no_grad():
        ref = block(xt, lt)
    out = block(xt, lt)
    assert out.grad_fn is not None and out.dtype == dtype
    assert torch.equal(out.detach(), ref)
    out.float().sum().backward()
    assert all(v == 0 for v in build.LAUNCHES.values())


@pytest.mark.parametrize("grad", [False, True])
def test_train_flag_applies_dropout_with_or_without_autograd(grad):
    """``train`` picks the training path whether or not autograd records:
    under no_grad a training forward still drops, with the same draw."""
    x, lengths, p = _block_case(75, T=40)
    block = _port_block(p, 1, dropout=0.5)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():
        ref = block(xt, lt, True, torch.Generator().manual_seed(3))
        assert not torch.equal(ref, block(xt, lt))
    with torch.set_grad_enabled(grad):
        out = block(xt, lt, True, torch.Generator().manual_seed(3))
    assert (out.grad_fn is not None) == grad
    assert torch.equal(out.detach(), ref)


def test_dropout_draws_from_the_generator():
    x, lengths, p = _block_case(80, T=40)
    block = _port_block(p, 1, dropout=0.5)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    run = lambda seed, train: block(xt, lt, train, torch.Generator().manual_seed(seed))  # noqa
    with torch.no_grad():
        ref = block(xt, lt)
    torch.testing.assert_close(run(0, False), ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(run(0, True), run(0, True))
    assert not torch.equal(run(0, True), run(1, True))
    y = (run(0, True) - xt)[0]                          # dropped entries leave x alone
    assert 0.3 < float((y == 0).float().mean()) < 0.7


def _audio(seed=0, B=3, A=48000):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, A)) * 0.3).astype(np.float32)
    lens = np.array([A, A * 3 // 4, A // 2 + 321], np.int32)[:B]
    for b, n in enumerate(lens):
        audio[b, n:] = 0.0
    return audio, lens


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    over = {**SMALL, "model.compute_dtype": request.param}
    jcfg = jax_get_config("tcn_ctc_devclean", **over)
    audio, lens = _audio()
    jmodel = JaxASRModel(jcfg.frontend, jcfg.model, 31)
    params = jmodel.init(jax.random.key(0), jnp.asarray(audio), jnp.asarray(lens),
                         train=False)["params"]
    params = jax.tree.map(np.asarray, params)
    model = evaluate.build_model(get_config("tcn_ctc_devclean", **over), "cpu",
                                 weights.load_jax_params(params))
    with torch.inference_mode():
        out = model(torch.from_numpy(audio), torch.from_numpy(lens))
    ours = {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in out.items()}
    refs = {}
    for interpret in (False, True):
        jax_runtime.force_interpret(True if interpret else None)
        try:
            ref = jmodel.apply({"params": params}, jnp.asarray(audio), jnp.asarray(lens),
                               train=False)
        finally:
            jax_runtime.force_interpret(None)
        refs["pallas_interpret" if interpret else "xla"] = {k: np.asarray(v, np.float32)
                                                             for k, v in ref.items()}
    return request.param, ours, refs, params


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_model_matches_jax(models, ref):
    """float32: logits to 1e-4 against both JAX paths, greedy ids equal
    where the top-2 gap is clear.  bf16: against interpret mode only (JAX's
    XLA path runs the block's conv in bf16, the Pallas path and the port in
    float32)."""
    dtype, ours, refs, _ = models
    if dtype == "bfloat16" and ref == "xla":
        ref = "pallas_interpret"
    want = refs[ref]
    np.testing.assert_array_equal(ours["enc_len"], want["enc_len"])
    got, logits = ours["ctc_logits"], want["ctc_logits"]
    assert got.shape == logits.shape and np.isfinite(got).all()
    tol = MODEL_TOL if dtype == "float32" else BF16_TOL * np.abs(logits).max()
    np.testing.assert_allclose(got, logits, rtol=0 if dtype == "bfloat16" else tol, atol=tol)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear], logits.argmax(-1)[clear])
    if dtype == "float32":
        ids, n = greedy_ctc(torch.from_numpy(got), torch.from_numpy(ours["enc_len"]))
        assert int(n.max()) > 0 and ids.shape[0] == got.shape[0]


def test_load_jax_params_maps_the_tcn_tree(models):
    """Every JAX leaf lands on a port parameter, the stem's WIO kernel as
    OIW; an unknown key raises."""
    _, _, _, params = models
    state = weights.load_jax_params(params)
    cfg = get_config("tcn_ctc_devclean", **SMALL)
    assert set(state) == set(ASRModel(cfg.frontend, cfg.model, 31).state_dict())
    np.testing.assert_array_equal(state["encoder.stem.weight"].numpy(),
                                  params["encoder"]["Conv_0"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["encoder.blocks.3.w_conv"].numpy(),
                                  params["encoder"]["block3"]["w_conv"])
    with pytest.raises(KeyError, match="encoder/block0/w_extra"):
        weights.load_jax_params({**params, "encoder": {**params["encoder"], "block0": {
            **params["encoder"]["block0"], "w_extra": np.zeros(2)}}})


def test_init_weights_follow_flax_initialisers():
    cfg = get_config("tcn_ctc_devclean", **{**SMALL, "model.encoder.channels": "64"})
    a = ASRModel(cfg.frontend, cfg.model, 31, seed=3).state_dict()
    b = ASRModel(cfg.frontend, cfg.model, 31, seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["encoder.blocks.0.ln_scale"], torch.ones(64))
    assert not a["encoder.blocks.0.b_conv"].any() and not a["encoder.final_ln.bias"].any()
    # truncated lecun-normal: std sqrt(1 / fan_in), fan_in = K * C for w_conv
    std = float(a["encoder.blocks.0.w_conv"].std())
    assert abs(std / (1 / (5 * 64)) ** 0.5 - 1) < 0.1
    assert a["ctc_head.weight"].shape == (31, 64)


def test_train_step_matches_jax():
    """One float32 train step, dropout 0 and SpecAugment off, from the same
    parameters: the loss and every gradient (JAX's CPU path differentiates
    its XLA block exactly; the port runs K6's plain pair)."""
    over = {**SMALL, "frontend.specaugment": "false", "data.synthetic_num_utts": "4",
            "data.batch_size": "4", "data.auto_buckets": "1"}
    jcfg = jax_get_config("tcn_ctc_devclean", **over)
    cfg = get_config("tcn_ctc_devclean", **over)
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_state.build_model(jcfg)
    jst = jax_state.init_train_state(jcfg, jmodel, batch)
    step_rng = jax.random.split(jax.random.wrap_key_data(jst.rng, impl=jcfg.train.rng_impl))[1]
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_state.compute_losses(jcfg, jmodel, p, jbatch, step_rng, train=True,
                                           step=jst.step), has_aux=True)(jst.params)
    model = port_state.build_model(cfg, torch.device("cpu"))
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, jst.params)))
    st = port_state.init_train_state(cfg, model)
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(float(aux["ctc_loss"]), float(jaux["ctc_loss"]), rtol=1e-5)
    named = dict(model.named_parameters())
    for name, ref in weights.load_jax_params(jax.tree.map(np.asarray, jgrads)).items():
        scale = float(ref.abs().max())
        torch.testing.assert_close(named[name].grad, ref, rtol=0, atol=1e-4 * max(scale, 1e-12),
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_decode_main_on_cpu(tmp_path, capsys):
    """Config 3's serving path: prefix beam K 16 without an LM, decode ladder."""
    argv = ["tcn_ctc_devclean", *(f"{k}={v}" for k, v in SMALL.items()), "device=cpu",
            "max_batches=1", "data.synthetic_num_utts=6", "data.batch_size=3",
            "decode.auto_buckets=2", "model.compute_dtype=bfloat16",
            f"train.checkpoint_dir={tmp_path}"]
    result = decode.main(argv)
    assert result["method"] == "prefix_beam"
    assert set(result) == {"method", "wer", "cer", "num_utts", "decode_rtf",
                           "padding_efficiency_decode", "world_size", "dist_backend"}
    assert 0 < result["num_utts"] <= 3 and result["decode_rtf"] > 0
    assert str(result) in capsys.readouterr().out


def test_train_main_on_cpu(tmp_path):
    """Config 3's training path with dropout 0.1 and SpecAugment on, then
    the greedy eval."""
    argv = ["tcn_ctc_devclean", "device=cpu", "steps=2", "train.eval_every=2",
            "train.log_every=1", f"train.checkpoint_dir={tmp_path}",
            "model.encoder.channels=32", "model.encoder.num_blocks=3",
            "data.synthetic_num_utts=4", "data.batch_size=2", "data.auto_buckets=1"]
    result = train.main(argv)
    assert result["train"]["step"] == 2 and np.isfinite(result["train"]["ctc_loss"])
    assert np.isfinite(result["train"]["grad_norm"]) and result["train"]["grad_norm"] > 0
    assert result["eval"]["num_utts"] == 4 and result["eval"]["step"] == 2
