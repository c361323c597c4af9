"""The port's LAS decoder, CE loss and CE / joint training losses against the
JAX package on the CPU, at small widths (decoder E 12 / H 24 / A 16,
location 5 x 4; encoder H 16 x 2), float32, the same weights loaded through
``weights.load_jax_params`` (which maps the gradient trees too).

Scheduled sampling draws from each framework's own generator, so the
teacher-forced decoder is compared at ``ss_prob`` 0 and 1, where the JAX
draw is deterministic.  The training losses are compared at ctc_weight 0
(config 4), 0.3 (config 5) and 1, with label smoothing 0.1, dropout 0 and
the augmentations off; then the train CLI runs both configs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.configs.base import LASDecoderConfig as JaxDecoderConfig
from pytorch_asr_tpu.models.las_decoder import LASDecoder as JaxLASDecoder
from pytorch_asr_tpu.ops import ce as jax_ce
from pytorch_asr_tpu.training import state as jax_state
from pytorch_asr_tpu_torch import train, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import LASDecoderConfig
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.models.encoder_bilstm import set_residual_dtype
from pytorch_asr_tpu_torch.models.las_decoder import LASDecoder
from pytorch_asr_tpu_torch.ops import ce
from pytorch_asr_tpu_torch.training import state as port_state

V = 31
DEC = dict(embed_dim=12, hidden_dim=24, attention_dim=16, location_kernel=5, location_filters=4)
SMALL = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
         "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
         "model.decoder.embed_dim": "12", "model.decoder.hidden_dim": "24",
         "model.decoder.attention_dim": "16", "model.decoder.location_kernel": "5",
         "model.decoder.location_filters": "4", "model.compute_dtype": "float32",
         "frontend.specaugment": "false", "frontend.waveform_augment": "false",
         "data.synthetic_num_utts": "6", "data.batch_size": "4", "data.auto_buckets": "1",
         "data.synthetic_max_sec": "2.0", "train.optim.peak_lr": "1e-3",
         "train.optim.warmup_steps": "1"}
# float32 on both sides: the decoder's products and softmaxes sum in other
# orders (measured ~3e-7 of the logits' scale).
DEC_TOL = 1e-5
# As tests/test_torch_train.py: the losses to 1e-5, the gradients to 1e-4
# of each tensor's largest entry (the frontends' FFTs, the convs and the CTC
# recursions sum in other orders).
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def decoders():
    """A JAX ``LASDecoder`` with scheduled sampling enabled, its params, the
    port's decoder with the same weights, and inputs: encoder rows of 11, 7
    and 0 valid frames, sos-prefixed targets."""
    rng = np.random.default_rng(0)
    B, T, D, U = 3, 11, 20, 6
    enc = rng.standard_normal((B, T, D)).astype(np.float32)
    enc_len = np.array([11, 7, 0], np.int32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    targets[:, 0] = 29
    jdec = JaxLASDecoder(JaxDecoderConfig(**DEC, scheduled_sampling=0.5), V, D)
    params = jax.jit(jdec.init)(jax.random.PRNGKey(1), jnp.asarray(enc), jnp.asarray(enc_len),
                                jnp.asarray(targets), None)["params"]
    params = {**params, "w_out": params["w_out"] * 4.0}     # decisive argmaxes
    dec = LASDecoder(LASDecoderConfig(**DEC, scheduled_sampling=0.5), V, D)
    dec.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return jdec, params, dec, enc, enc_len, targets


@pytest.mark.parametrize("ss_prob", [0.0, 1.0])
def test_teacher_forced_logits_match_jax(decoders, ss_prob):
    """Train mode with scheduled sampling on: at ss_prob 0 every input is the
    teacher's, at 1 every input after step 0 is the previous argmax."""
    jdec, params, dec, enc, enc_len, targets = decoders
    ref = jdec.apply({"params": params}, jnp.asarray(enc), jnp.asarray(enc_len),
                     jnp.asarray(targets), None, train=True, ss_prob=ss_prob,
                     rngs={"dropout": jax.random.PRNGKey(2)})
    with torch.no_grad():
        got = dec(torch.from_numpy(enc), torch.from_numpy(enc_len), torch.from_numpy(targets),
                  train=True, ss_prob=ss_prob, generator=torch.Generator().manual_seed(0))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DEC_TOL, atol=DEC_TOL)
    if ss_prob == 1.0:    # the argmaxes were fed back, so they must agree
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(ref).argmax(-1))


def test_step_matches_jax(decoders):
    """``init_state`` and two ``step`` calls: logits and every state field
    (the row of 0 frames attends uniformly, finitely)."""
    jdec, params, dec, enc, enc_len, targets = decoders
    apply = lambda method, *a: jdec.apply({"params": params}, *a, method=method)  # noqa: E731
    jenc, jlen = jnp.asarray(enc), jnp.asarray(enc_len)
    jproj = apply(JaxLASDecoder.project_encoder, jenc)
    jst = apply(JaxLASDecoder.init_state, jenc, jlen)
    mask = np.arange(enc.shape[1])[None, :] < enc_len[:, None]
    tenc, tlen = torch.from_numpy(enc), torch.from_numpy(enc_len)
    with torch.no_grad():
        proj = dec.project_encoder(tenc)
        st = dec.init_state(tenc, tlen)
        np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=DEC_TOL, atol=DEC_TOL)
        for u in range(2):
            y = targets[:, u]
            jlogits, jst = apply(JaxLASDecoder.step, jenc, jproj, jnp.asarray(mask),
                                 jnp.asarray(y), jst)
            logits, st = dec.step(tenc, proj, torch.from_numpy(mask), torch.from_numpy(y), st)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=DEC_TOL,
                                       atol=DEC_TOL)
            for got, ref in zip(st, jst):
                assert torch.isfinite(got).all()
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DEC_TOL,
                                           atol=DEC_TOL)
    np.testing.assert_allclose(st.att[2].numpy(), np.full(enc.shape[1], 1 / enc.shape[1]),
                               rtol=1e-6)


def test_decoder_io_and_smoothed_ce_match_jax():
    """A padded row (token_len 0) and a full one; smoothing 0 and 0.1."""
    rng = np.random.default_rng(3)
    tokens = np.array([[5, 6, 7, 0], [1, 2, 3, 4], [0, 0, 0, 0]], np.int32)
    token_len = np.array([3, 4, 0], np.int32)
    io = ce.make_decoder_io(torch.from_numpy(tokens), torch.from_numpy(token_len), 29, 30)
    jio = jax_ce.make_decoder_io(jnp.asarray(tokens), jnp.asarray(token_len), 29, 30)
    for got, ref in zip(io, jio):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert io[1][0].tolist() == [5, 6, 7, 30, 0] and io[2].tolist() == [4, 5, 1]
    logits = rng.standard_normal((3, 5, V)).astype(np.float32) * 3
    for eps in (0.0, 0.1):
        for lens in (io[2].numpy(), np.array([4, 5, 0], np.int32)):
            got = ce.smoothed_ce_loss(torch.from_numpy(logits), io[1], torch.from_numpy(lens), eps)
            ref = jax_ce.smoothed_ce_loss(jnp.asarray(logits), jio[1], jnp.asarray(lens), eps)
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _jax_losses(jcfg, jmodel, params, batch, step):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_state.compute_losses(jcfg, jmodel, p, jbatch, jax.random.PRNGKey(0),
                                           train=True, step=step), has_aux=True))(params)
    return {k: float(v) for k, v in aux.items() if k.endswith("loss")}, \
        weights.load_jax_params(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def joint_setup():
    """The JAX train state of the small joint config, its batch (row 3 a pad
    row), and the overrides; every ctc_weight shares the weights."""
    jcfg = jax_get_config("joint_ctc_attention_960h", **SMALL)
    cfg = get_config("joint_ctc_attention_960h", **SMALL)
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    batch["audio_len"][3] = batch["token_len"][3] = 0
    batch["audio"][3] = 0.0
    batch["tokens"][3] = 0
    jmodel = jax_state.build_model(jcfg)
    # jitted: one compile instead of an eager op-by-op init (~4x faster here)
    jst = jax.jit(functools.partial(jax_state.init_train_state, jcfg, jmodel))(batch)
    return jmodel, jst, batch


def _port_model(cfg, jst):
    model = set_residual_dtype(port_state.build_model(cfg, torch.device("cpu")), torch.float32)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, jst.params)))
    return model


@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
def test_losses_and_gradients_match_jax(joint_setup, lam):
    """CE only (config 4), 0.3 CTC + 0.7 CE (config 5), CTC only: the loss
    terms and every gradient; the head off the loss's graph gets none."""
    jmodel, jst, batch = joint_setup
    over = {**SMALL, "model.ctc_weight": str(lam)}
    jcfg, cfg = jax_get_config("joint_ctc_attention_960h", **over), get_config(
        "joint_ctc_attention_960h", **over)
    ref, jgrads = _jax_losses(jcfg, jmodel, jst.params, batch, jst.step)
    model = _port_model(cfg, jst)
    loss, aux = port_state.compute_losses(cfg, model, port_state.batch_to_device(
        batch, torch.device("cpu")), torch.Generator().manual_seed(0), train=True, step=0)
    loss.backward()
    got = {k: float(v.detach()) for k, v in aux.items() if k.endswith("loss")}
    assert got.keys() == ref.keys() == ({"loss", "ce_loss"} if lam == 0 else {
        "loss", "ctc_loss"} if lam == 1 else {"loss", "ctc_loss", "ce_loss"})
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    for name, want in jgrads.items():
        g = named[name].grad
        if g is None:      # off the graph: JAX's gradient there is exactly 0
            assert (lam == 0 and name.startswith("ctc_head")) or (
                lam == 1 and name.startswith("las")), name
            assert not want.any(), name
            continue
        scale = max(float(want.abs().max()), 1e-12)
        torch.testing.assert_close(g, want, rtol=0, atol=GRAD_TOL * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_ctc_head_decays_at_ctc_weight_zero(joint_setup):
    """Config 4 gives the CTC head no gradient; the train step feeds it zeros,
    so AdamW moves it by its decoupled decay alone, -lr wd p, as optax."""
    jmodel, jst, batch = joint_setup
    over = {**SMALL, "model.ctc_weight": "0.0", "train.optim.weight_decay": "0.1"}
    jcfg, cfg = jax_get_config("las_attention", **over), get_config("las_attention", **over)
    jnew, _ = jax.jit(jax_state.make_train_step(jcfg, jmodel))(
        jst.replace(opt_state=jax_state.make_optimizer(jcfg.train.optim).init(jst.params)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, jst)
    st = port_state.init_train_state(cfg, model)
    before = model.ctc_head.weight.detach().clone()
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, torch.device("cpu")))
    assert model.ctc_head.weight.grad is None and "ctc_loss" not in aux
    want = weights.load_jax_params(jax.tree.map(np.asarray, jnew.params))["ctc_head.weight"]
    torch.testing.assert_close(model.ctc_head.weight.detach(), want, rtol=1e-6, atol=0)
    torch.testing.assert_close(model.ctc_head.weight.detach(), before * (1 - aux["lr"] * 0.1),
                               rtol=1e-6, atol=0)
    assert not torch.equal(model.ctc_head.weight.detach(), before)


def test_load_jax_params_maps_the_decoder(joint_setup):
    _, jst, _ = joint_setup
    state = weights.load_jax_params(jax.tree.map(np.asarray, jst.params))
    las = {k for k in state if k.startswith("las.")}
    assert las == {f"las.{k}" for k in jst.params["las"]}
    assert state["las.loc_filter"].shape == (5, 1, 4)
    assert state["las.w_out"].shape == (24 + 32, V)
    with pytest.raises(KeyError, match="las/w"):
        weights.load_jax_params({"las": {"w": np.zeros(2)}})


@pytest.mark.parametrize("config", ["las_attention", "joint_ctc_attention_960h"])
def test_train_cli_on_the_cpu(config, tmp_path):
    """Two steps and the greedy eval through ``train.main``, config 5 with its
    waveform augmentation on; the losses of the config's lambda are logged."""
    over = {k: v for k, v in SMALL.items() if not k.startswith("frontend.waveform")}
    argv = [config, "device=cpu", "steps=2", "train.eval_every=2", "train.log_every=1",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}", *(f"{k}={v}" for k, v in over.items())]
    last = train.main(argv)
    rec = last["train"]
    assert rec["step"] == 2 and np.isfinite(rec["loss"]) and np.isfinite(rec["ce_loss"])
    assert ("ctc_loss" in rec) == (config == "joint_ctc_attention_960h")
    assert last["eval"]["num_utts"] > 0
