"""``train.remat_encoder``: the encoder under activation checkpointing.

At configs 1 and 3 (small widths, float32, dropout 0.1, SpecAugment on)
remat on and off give the same loss, gradients, parameters after the update
and generator state, bit for bit, while each encoder unit (an LSTM direction,
a TCN block) runs its forward twice a step instead of once: the recompute
replays the generator's draws.  At dropout 0 the port's remat step matches
the JAX package's ``nn.remat`` step to ``tests/test_torch_train.py``'s
tolerances.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.training import state as jax_state
from pytorch_asr_tpu_torch import weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.models.encoder_bilstm import LSTMDirection, set_residual_dtype
from pytorch_asr_tpu_torch.models.encoder_tcn import TCNBlock
from pytorch_asr_tpu_torch.training import state as port_state
from tests.test_torch_train import GRAD_TOL, LOSS_RTOL, SMALL

CPU = torch.device("cpu")
CASES = {
    "ctc_bilstm_dev1h": ({"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
                          "model.encoder.conv_channels": "4,4"}, LSTMDirection, 4),
    "tcn_ctc_devclean": ({"model.encoder.channels": "32", "model.encoder.num_blocks": "3"},
                         TCNBlock, 3),
}
COMMON = {"model.encoder.dropout": "0.1", "model.compute_dtype": "float32",
          "frontend.specaugment": "true", "data.synthetic_num_utts": "4",
          "data.batch_size": "4", "data.auto_buckets": "1", "data.synthetic_max_sec": "2",
          "train.optim.peak_lr": "1e-3", "train.optim.warmup_steps": "1"}
# test_torch_train.py's settings (dropout 0, SpecAugment off) with remat.
JAX_PAIR = {**{k: v for k, v in SMALL.items() if not k.startswith("model.encoder.")},
            "model.encoder.dropout": "0.0", "train.remat_encoder": "true"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step(config: str, remat: bool) -> dict:
    over, unit, units = CASES[config]
    cfg = get_config(config, **{**over, **COMMON, "train.remat_encoder": str(remat).lower()})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = port_state.build_model(cfg, CPU)
    assert model.remat_encoder is remat
    st = port_state.init_train_state(cfg, model)
    forwards = []
    hooks = [m.register_forward_hook(lambda *_: forwards.append(1))
             for m in model.modules() if isinstance(m, unit)]
    assert len(hooks) == units
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, CPU))
    for h in hooks:
        h.remove()
    return {"loss": aux["loss"], "grads": {k: p.grad for k, p in model.named_parameters()},
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "generator": st.generator.get_state(), "forwards": len(forwards), "units": units}


@pytest.mark.parametrize("config", sorted(CASES))
def test_remat_on_and_off_agree_bit_for_bit(config):
    off, on = _step(config, False), _step(config, True)
    assert off["forwards"] == off["units"] and on["forwards"] == 2 * on["units"]
    assert torch.equal(on["loss"], off["loss"])
    assert on["grads"].keys() == off["grads"].keys()
    for k, g in off["grads"].items():
        assert torch.equal(on["grads"][k], g), k
    for k, v in off["params"].items():
        assert torch.equal(on["params"][k], v), k
    assert torch.equal(on["generator"], off["generator"])


def test_remat_off_the_tape_runs_the_encoder_once():
    over, unit, units = CASES["ctc_bilstm_dev1h"]
    cfg = get_config("ctc_bilstm_dev1h", **{**over, **COMMON, "train.remat_encoder": "true"})
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    model = port_state.build_model(cfg, CPU)
    forwards = []
    for m in model.modules():
        if isinstance(m, unit):
            m.register_forward_hook(lambda *_: forwards.append(1))
    with torch.no_grad():
        model(torch.from_numpy(batch["audio"]), torch.from_numpy(batch["audio_len"]))
    assert len(forwards) == units


@pytest.mark.parametrize("config", sorted(CASES))
def test_remat_step_matches_jax_remat(config):
    over = {**CASES[config][0], **JAX_PAIR}
    jcfg = jax_get_config(config, **over)
    cfg = get_config(config, **over)
    assert jcfg.train.remat_encoder and cfg.train.remat_encoder
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_state.build_model(jcfg)
    jst = jax_state.init_train_state(jcfg, jmodel, batch)
    step_rng = jax.random.split(jax.random.wrap_key_data(jst.rng, impl=jcfg.train.rng_impl))[1]
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_state.compute_losses(jcfg, jmodel, p, jbatch, step_rng, train=True,
                                           step=jst.step), has_aux=True)(jst.params)
    model = set_residual_dtype(port_state.build_model(cfg, CPU), torch.float32)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, jst.params)))
    st = port_state.init_train_state(cfg, model)
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, CPU))
    np.testing.assert_allclose(float(aux["ctc_loss"]), float(jaux["ctc_loss"]), rtol=LOSS_RTOL)
    named = dict(model.named_parameters())
    ref = weights.load_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(named) == set(ref)
    for name, want in ref.items():
        scale = float(want.abs().max())
        torch.testing.assert_close(named[name].grad, want, rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-12),
                                   msg=lambda m, name=name: f"{name}: {m}")
