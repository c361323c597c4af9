"""The port's training path vs the JAX package, on the CPU, at a small size.

One ``train_step`` of the port against JAX's ``make_train_step`` from the same
parameters (``weights.load_jax_params`` maps both the parameter and the
gradient trees), at float32 with dropout 0 and SpecAugment off; the
optimizer against optax; SpecAugment's properties; a checkpoint resume; and
the training CLI.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.training import state as jax_state
from pytorch_asr_tpu_torch import train, weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import OptimConfig
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.frontend import specaugment
from pytorch_asr_tpu_torch.models.encoder_bilstm import set_residual_dtype
from pytorch_asr_tpu_torch.training import state as port_state
from pytorch_asr_tpu_torch.training.trainer import Trainer

SMALL = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
         "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
         "model.compute_dtype": "float32", "frontend.specaugment": "false",
         "data.synthetic_num_utts": "6", "data.batch_size": "4", "data.auto_buckets": "1",
         "train.optim.peak_lr": "1e-3", "train.optim.warmup_steps": "1"}
# float32 on both sides; the frontends' FFTs, the convs and the CTC
# recursions sum in other orders (the slice's logits agree to 1e-5).
LOSS_RTOL = 1e-5
# Gradients, relative to each tensor's largest entry.
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


def _flat(tree):
    return {k: np.asarray(v) for k, v in weights.flatten(tree).items()}


@pytest.fixture(scope="module")
def step_pair():
    """(JAX grads, JAX aux, JAX params before and after, port state and aux)."""
    jcfg = jax_get_config("ctc_bilstm_dev1h", **SMALL)
    cfg = get_config("ctc_bilstm_dev1h", **SMALL)
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    batch["audio_len"][3] = batch["token_len"][3] = 0          # a pad row
    batch["audio"][3] = 0.0
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_state.build_model(jcfg)
    jst = jax_state.init_train_state(jcfg, jmodel, batch)
    step_rng = jax.random.split(jax.random.wrap_key_data(jst.rng, impl=jcfg.train.rng_impl))[1]
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_state.compute_losses(jcfg, jmodel, p, jbatch, step_rng, train=True,
                                           step=jst.step), has_aux=True)(jst.params)
    jnew, jaux_step = jax.jit(jax_state.make_train_step(jcfg, jmodel))(jst, jbatch)

    # JAX's CPU path differentiates its scan exactly, so the port saves float32
    # residuals here (its default, bfloat16, rounds them as the TPU path does).
    model = set_residual_dtype(port_state.build_model(cfg, torch.device("cpu")), torch.float32)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, jst.params)))
    st = port_state.init_train_state(cfg, model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, torch.device("cpu")))
    return {"jgrads": weights.load_jax_params(jax.tree.map(np.asarray, jgrads)),
            "jaux": jaux, "jaux_step": jaux_step,
            "jnew": weights.load_jax_params(jax.tree.map(np.asarray, jnew.params)),
            "state": st, "aux": aux, "before": before}


def test_train_step_loss_norm_and_lr_match_jax(step_pair):
    aux, jaux = step_pair["aux"], step_pair["jaux_step"]
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ctc_loss"]), float(jaux["ctc_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]), rtol=GRAD_TOL)
    np.testing.assert_allclose(aux["lr"], float(jaux["lr"]), rtol=1e-6)
    assert step_pair["state"].step == 1


def test_train_step_grads_match_jax(step_pair):
    named = dict(step_pair["state"].model.named_parameters())
    assert set(named) == set(step_pair["jgrads"])
    for name, ref in step_pair["jgrads"].items():
        got = named[name].grad
        assert got is not None, name
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, rtol=0, atol=GRAD_TOL * max(scale, 1e-12),
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_train_step_params_after_adamw_match_jax(step_pair):
    """After one AdamW step each coordinate moves by about lr * sign(g); where
    |g| is at float32 noise the two frameworks may move it in opposite
    directions, so the bound is 2 lr.  Where |g| is clear of the noise the
    moves agree closely."""
    lr = step_pair["aux"]["lr"]
    now = step_pair["state"].model.state_dict()
    for name, ref in step_pair["jnew"].items():
        torch.testing.assert_close(now[name], ref, rtol=0, atol=2 * lr)
        g = step_pair["jgrads"][name]
        clear = g.abs() > 1e-3 * g.abs().max()
        moved, ref_moved = (now[name] - step_pair["before"][name]), (ref - step_pair["before"][name])
        torch.testing.assert_close(moved[clear], ref_moved[clear], rtol=1e-3, atol=1e-3 * lr)


@pytest.mark.parametrize("schedule", ["noam", "constant", "cosine", "exponential"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(schedule=schedule, peak_lr=2e-3, warmup_steps=10, total_steps=100,
              end_lr_fraction=0.05)
    ours = port_state.lr_schedule(OptimConfig(**kw))
    ref = jax_state.lr_schedule(dataclasses.replace(jax_get_config("ctc_bilstm_dev1h").train.optim,
                                                    **kw))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,))]
    ours = port_state.clip_by_global_norm([torch.from_numpy(g) for g in grads], 5.0)
    ref, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in grads], None)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)


def _optax_run(kw, grads_seq, params):
    jcfg = dataclasses.replace(jax_get_config("ctc_bilstm_dev1h").train.optim, **kw)
    tx = jax_state.make_optimizer(jcfg)
    p = [jnp.asarray(a) for a in params]
    st = tx.init(p)
    for g in grads_seq:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, p)
        p = optax.apply_updates(p, upd)
    return [np.asarray(a) for a in p]


def _port_run(kw, grads_seq, params):
    ps = [torch.from_numpy(a.copy()) for a in params]
    opt = port_state.make_optimizer(OptimConfig(**kw), ps)
    moved = [opt.step([torch.from_numpy(a) for a in g]) for g in grads_seq]
    return [p.numpy() for p in ps], moved


def _grads_seq(n, scale=1.0):
    rng = np.random.default_rng(1)
    return [[(rng.standard_normal(s) * scale).astype(np.float32) for s in ((4, 6), (6,))]
            for _ in range(n)]


@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(optimizer, accum):
    kw = dict(optimizer=optimizer, peak_lr=1e-2, warmup_steps=2, total_steps=20,
              weight_decay=0.1, accum_steps=accum, grad_clip_norm=3.0)
    params = [a * 0.5 for a in _grads_seq(1)[0]]
    seq = _grads_seq(6, scale=2.0)
    ours, moved = _port_run(kw, seq, params)
    assert moved == [accum == 1 or i % 2 == 1 for i in range(6)]
    for o, r in zip(ours, _optax_run(kw, seq, params)):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6)


def test_accumulation_is_one_update_from_the_clipped_mean():
    kw = dict(optimizer="adamw", peak_lr=1e-2, warmup_steps=1, accum_steps=2,
              grad_clip_norm=1.0)
    params = [a * 0.5 for a in _grads_seq(1)[0]]
    g1, g2 = _grads_seq(2, scale=3.0)
    two, _ = _port_run(kw, [g1, g2], params)
    mean = [(a + b) / 2 for a, b in zip(g1, g2)]
    one, _ = _port_run({**kw, "accum_steps": 1}, [mean], params)
    for a, b in zip(two, one):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _tiny(**extra):
    over = {**SMALL, "train.log_every": "1", **extra}
    return get_config("ctc_bilstm_dev1h", **over)


def test_ema_blends_only_on_updates():
    cfg = _tiny(**{"train.ema_decay": "0.5", "train.optim.accum_steps": "2"})
    st = port_state.init_train_state(cfg, port_state.build_model(cfg, torch.device("cpu")))
    batches = build_dataset(cfg.data, cfg.frontend.sample_rate).repeat_batches(0)
    snap = lambda m: [p.detach().clone() for p in m.parameters()]  # noqa: E731
    ema0, p0 = snap(st.ema), snap(st.model)
    port_state.train_step(cfg, st, port_state.batch_to_device(next(batches), torch.device("cpu")))
    assert all(torch.equal(a, b) for a, b in zip(snap(st.ema), ema0))    # no update yet
    assert all(torch.equal(a, b) for a, b in zip(snap(st.model), p0))
    port_state.train_step(cfg, st, port_state.batch_to_device(next(batches), torch.device("cpu")))
    p2 = snap(st.model)
    for e, e0, p in zip(snap(st.ema), ema0, p2):
        torch.testing.assert_close(e, 0.5 * e0 + 0.5 * p)
    assert port_state.eval_params(st) is st.ema


def test_specaugment_masks_stay_within_bounds():
    cfg = specaugment.SpecAugmentConfig(num_freq_masks=2, freq_mask_width=7, num_time_masks=3,
                                        time_mask_fraction=0.1)
    g = torch.Generator().manual_seed(0)
    feat_len = torch.tensor([100, 60, 1, 0])
    for _ in range(20):
        time_keep, freq_keep = specaugment.draw_masks(g, feat_len, 100, 40, cfg)
        assert (~freq_keep).sum(1).max() <= 2 * 6            # widths in [0, 7)
        for b, n in enumerate(feat_len.tolist()):
            dropped = (~time_keep[b]).nonzero().flatten()
            assert len(dropped) <= 3 * max(1, int(n * 0.1))
            if len(dropped):
                assert dropped.max() < max(n, 1)              # masks start within the row
    feats = torch.randn(4, 100, 40, generator=g)
    out = specaugment.spec_augment(feats, feat_len, cfg, g)
    assert ((out == 0) | (out == feats)).all()


def test_specaugment_disabled_is_identity_and_warp_keeps_padding():
    feats = torch.randn(3, 50, 8)
    feat_len = torch.tensor([50, 30, 10])
    off = specaugment.SpecAugmentConfig(enabled=False)
    assert specaugment.spec_augment(feats, feat_len, off) is feats
    g = torch.Generator().manual_seed(1)
    w0, w = specaugment.draw_warp(g, feat_len, 5)
    assert ((w0 >= 5) & (w >= -5) & (w <= 5)).all()
    warped = specaugment.time_warp(feats, feat_len, 5, w0, w)
    assert torch.equal(warped[1, 30:], feats[1, 30:])         # padded frames untouched
    assert torch.equal(warped[2], feats[2])                   # too short to warp
    assert torch.equal(specaugment.time_warp(feats, feat_len, 5, w0, torch.zeros_like(w)),
                       feats)                                 # no shift: identity


def test_checkpoint_resume_continues_bit_for_bit(tmp_path):
    """Four steps straight vs two, a checkpoint, a new trainer and two more.
    Dropout and SpecAugment are on, so the generator's state matters too."""
    cfg = _tiny(**{"model.encoder.dropout": "0.2", "frontend.specaugment": "true"})
    straight = Trainer(cfg, checkpoint_dir=str(tmp_path / "a"), device="cpu")
    straight.train(4)
    Trainer(cfg, checkpoint_dir=str(tmp_path / "b"), device="cpu").train(2)
    resumed = Trainer(cfg, checkpoint_dir=str(tmp_path / "b"), device="cpu")
    assert resumed.state.step == 2
    resumed.train(2)
    for p, q in zip(straight.state.model.parameters(), resumed.state.model.parameters()):
        assert torch.equal(p, q)
    assert straight.stream.get_state() == resumed.stream.get_state()
    assert torch.equal(straight.state.generator.get_state(), resumed.state.generator.get_state())


def test_train_cli_on_cpu(tmp_path, capsys):
    argv = ["ctc_bilstm_dev1h", "device=cpu", "steps=2", "train.eval_every=2",
            "train.log_every=1",
            f"train.checkpoint_dir={tmp_path}", f"metrics_path={tmp_path / 'm.jsonl'}"]
    argv += [f"{k}={v}" for k, v in SMALL.items()]
    result = train.main(argv)
    assert result["train"]["step"] == 2 and np.isfinite(result["train"]["ctc_loss"])
    assert result["eval"]["num_utts"] == 6 and result["eval"]["step"] == 2
    events = [line for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(events) == 3                                   # train 1, train 2, eval
    # tb_dir mirrors the records to TensorBoard event files.
    train.main(argv + ["steps=1", f"train.checkpoint_dir={tmp_path / 'tb_run'}",
                       f"tb_dir={tmp_path / 'tb'}"])
    assert any("tfevents" in f.name for f in (tmp_path / "tb").iterdir())
