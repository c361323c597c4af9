"""The port's streaming-capable model and greedy streaming recognizer
(``decoding/streaming.py``) against the JAX package on the CPU.

JAX's own streaming test model (``tests/test_streaming.py``): conv (8, 8)
3x3 stride 2x2 with causal time padding, a unidirectional LSTM of H 32 x 2
layers, V 12, float32, ``frontend.normalize`` off; its params loaded into the
port through ``weights.load_jax_params``.  On the CPU the port's K1 and K2
wrappers take their plain versions; the card's kernels are held in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.configs import get_config as jax_get_config
from pytorch_asr_tpu.configs.base import BiLSTMEncoderConfig as JaxEncoderConfig
from pytorch_asr_tpu.configs.base import DataConfig as JaxDataConfig
from pytorch_asr_tpu.configs.base import DecodeConfig as JaxDecodeConfig
from pytorch_asr_tpu.configs.base import ExperimentConfig as JaxExperimentConfig
from pytorch_asr_tpu.configs.base import FrontendConfig as JaxFrontendConfig
from pytorch_asr_tpu.configs.base import ModelConfig as JaxModelConfig
from pytorch_asr_tpu.decoding import streaming as jax_streaming
from pytorch_asr_tpu.models.asr_model import ASRModel as JaxASRModel
from pytorch_asr_tpu.models.encoder_bilstm import conv_out_len_causal as jax_conv_out_len_causal
from pytorch_asr_tpu.training import state as jax_state
from pytorch_asr_tpu_torch import weights
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.configs.base import (
    BiLSTMEncoderConfig,
    DataConfig,
    DecodeConfig,
    ExperimentConfig,
    FrontendConfig,
    ModelConfig,
)
from pytorch_asr_tpu_torch.data import build_dataset
from pytorch_asr_tpu_torch.decoding.greedy import greedy_ctc
from pytorch_asr_tpu_torch.decoding.streaming import StreamingRecognizer, init_stream_state
from pytorch_asr_tpu_torch.models.asr_model import ASRModel, encoder_output_dim
from pytorch_asr_tpu_torch.models.encoder_bilstm import conv_out_len_causal, set_residual_dtype
from pytorch_asr_tpu_torch.ops import lstm_cuda
from pytorch_asr_tpu_torch.training import state as port_state

VOCAB = 12
ENC = dict(conv_channels=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), hidden_dim=32,
           num_layers=2, dropout=0.0, use_pallas=False, bidirectional=False, causal_conv=True)
# float32 on both sides: the FFTs, convs and products sum in other orders
# (the logits agree to ~7e-7).
LOGIT_TOL = 1e-5
# The CLIs' override syntax for the streaming-capable model, and a small
# width for the train-step parity (as tests/test_torch_train.py's).
CAUSAL = {"model.encoder.bidirectional": "false", "model.encoder.causal_conv": "true",
          "frontend.normalize": "false"}
SMALL = {"model.encoder.hidden_dim": "16", "model.encoder.num_layers": "2",
         "model.encoder.conv_channels": "4,4", "model.encoder.dropout": "0.0",
         "model.encoder.use_pallas": "false", "model.compute_dtype": "float32",
         "frontend.specaugment": "false", "data.synthetic_num_utts": "4",
         "data.batch_size": "4", "data.auto_buckets": "1", "data.synthetic_max_sec": "2.0",
         "train.optim.peak_lr": "1e-3", "train.optim.warmup_steps": "1", **CAUSAL}
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4          # tests/test_torch_train.py's
N = (64 - 1) * 160 + 400                  # 64 frames: 4 blocks of 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for this module's tests, then as before:
    the test runner's workers share the machine's cores, and a thread a core
    in every worker oversubscribes them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**enc):
    kw = {**ENC, **enc}
    jax_cfg = JaxExperimentConfig(
        name="streaming_test", frontend=JaxFrontendConfig(normalize=False, specaugment=False),
        data=JaxDataConfig(), decode=JaxDecodeConfig(method="greedy"),
        model=JaxModelConfig(encoder=JaxEncoderConfig(**kw), ctc_weight=1.0,
                             compute_dtype="float32"))
    cfg = ExperimentConfig(
        name="streaming_test", frontend=FrontendConfig(normalize=False, specaugment=False),
        data=DataConfig(), decode=DecodeConfig(method="greedy"),
        model=ModelConfig(encoder=BiLSTMEncoderConfig(**kw), ctc_weight=1.0,
                          compute_dtype="float32"))
    return jax_cfg, cfg


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX model, params, port config, port model with those params)."""
    jax_cfg, cfg = _cfgs()
    jmodel = JaxASRModel(jax_cfg.frontend, jax_cfg.model, vocab_size=VOCAB)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16000), jnp.float32),
                                  jnp.array([16000]))["params"]
    model = ASRModel(cfg.frontend, cfg.model, VOCAB)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, params)))
    return jax_cfg, jmodel, params, cfg, model.eval()


def _audio(B: int = 2) -> np.ndarray:
    """tests/test_streaming.py's structured audio: sines with a slow envelope
    plus 0.1 noise, so greedy CTC emits tokens at random weights."""
    t = np.arange(N, dtype=np.float32) / 16000.0
    audio = np.stack([np.sin(2 * np.pi * (300 + 70 * b) * t)
                      * (1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)) for b in range(B)])
    rng = np.random.default_rng(2)
    return (audio + rng.normal(size=audio.shape) * 0.1).astype(np.float32)


def _feed(rec, audio: np.ndarray, chunk: int) -> list[list[int]]:
    got = [[] for _ in range(audio.shape[0])]
    for off in range(0, audio.shape[1], chunk):
        for b, new in enumerate(rec.accept(audio[:, off:off + chunk])):
            got[b].extend(new)
    for b, new in enumerate(rec.finish()):
        got[b].extend(new)
    return got


def test_conv_out_len_causal_matches_jax():
    L = np.arange(0, 40)
    for k in (1, 2, 3, 5):
        for s in (1, 2, 3):
            want = np.asarray(jax_conv_out_len_causal(jnp.asarray(L), k, s))
            got = conv_out_len_causal(torch.from_numpy(L), k, s).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"k {k} s {s}")


def test_unidirectional_encoder_dims_and_lengths(models):
    _, _, _, cfg, model = models
    assert encoder_output_dim(cfg.model) == 32
    assert list(model.encoder.layers[0]) == ["fwd"]
    assert model.encoder.layers[1]["fwd"].wih.shape == (32, 128)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32))
    with torch.no_grad():
        out = model(audio, torch.tensor([16000, 12000]))
    assert out["enc"].shape == (2, 25, 32)
    # 98 and 73 frames: ceil(/2) twice -> 25 and 19
    assert out["enc_len"].tolist() == [25, 19]


def test_causal_model_is_causal(models):
    """Editing the future leaves past encoder frames equal."""
    *_, model = models
    rng = np.random.default_rng(1)
    a = rng.normal(size=(1, 32000)).astype(np.float32)
    b = a.copy()
    b[:, 24000:] += rng.normal(size=(1, 8000)).astype(np.float32)
    with torch.no_grad():
        ea, eb = (model(torch.from_numpy(x), torch.tensor([32000]))["enc"] for x in (a, b))
    # 24000 samples -> 148 frames -> 37 encoder frames untouched.
    torch.testing.assert_close(ea[:, :37], eb[:, :37], rtol=0, atol=0)
    assert not torch.allclose(ea, eb)


def test_offline_causal_model_matches_jax(models):
    jax_cfg, jmodel, params, cfg, model = models
    audio = _audio(3)
    lens = np.array([N, 9000, 4000], np.int32)
    want = jmodel.apply({"params": params}, jnp.asarray(audio), jnp.asarray(lens))
    with torch.no_grad():
        got = model(torch.from_numpy(audio), torch.from_numpy(lens))
    np.testing.assert_array_equal(got["enc_len"].numpy(), np.asarray(want["enc_len"]))
    np.testing.assert_allclose(got["ctc_logits"].numpy(), np.asarray(want["ctc_logits"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _lstm_case(B=3, T=11, D=20, H=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, T, D) * 0.5, f(D, 4 * H) / D ** 0.5, f(H, 4 * H) / H ** 0.5, f(4 * H) * 0.1,
            np.array([T, 7, 0], np.int32), f(B, H) * 0.3, f(B, H) * 0.3)


def test_plain_carry_matches_jax_lstm_chunk():
    x, wih, whh, bias, lens, h0, c0 = _lstm_case()
    T = x.shape[1]
    xproj = jnp.swapaxes(jnp.asarray(x) @ jnp.asarray(wih) + jnp.asarray(bias), 0, 1)
    valid = (np.arange(T)[None, :] < lens[:, None]).T
    hs, h, c = jax_streaming._lstm_chunk(xproj, jnp.asarray(whh), jnp.asarray(h0),
                                         jnp.asarray(c0), jnp.asarray(valid))
    t = torch.from_numpy
    out, hT, cT = lstm_cuda.lstm_seq_stream(t(x), t(wih), t(whh), t(bias), t(lens), t(h0), t(c0))
    want = np.where(valid.T[..., None], np.swapaxes(np.asarray(hs), 0, 1), 0.0)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cT.numpy(), np.asarray(c), rtol=1e-6, atol=1e-6)
    assert torch.equal(hT[2], t(h0)[2]) and torch.equal(cT[2], t(c0)[2])   # no steps


@pytest.mark.parametrize("cuts", [(4, 4, 3), (1, 5, 5), (6, 5)])
def test_plain_carry_over_chunks_equals_one_pass(cuts):
    """Chunks carrying (h, c), each with its rows' remaining lengths, give
    one pass's bits: the outputs and the final state."""
    x, wih, whh, bias, lens, h0, c0 = (torch.from_numpy(a) for a in _lstm_case())
    whole, h_all, c_all = lstm_cuda.lstm_seq_plain(x, wih, whh, bias, lens, h0=h0, c0=c0)
    outs, h, c, t0 = [], h0, c0, 0
    for n in cuts:
        part_len = torch.clamp(lens - t0, 0, n).int()
        out, h, c = lstm_cuda.lstm_seq_plain(x[:, t0:t0 + n], wih, whh, bias, part_len, h0=h,
                                             c0=c)
        outs.append(out)
        t0 += n
    assert torch.equal(torch.cat(outs, dim=1), whole)
    assert torch.equal(h, h_all) and torch.equal(c, c_all)


def test_stream_refuses_autograd_and_reverse():
    x, wih, whh, bias, lens, h0, c0 = (torch.from_numpy(a) for a in _lstm_case())
    with pytest.raises(ValueError, match="forward only"):
        lstm_cuda.lstm_seq_stream(x, wih, whh, bias, lens, h0, c0, reverse=True)
    with pytest.raises(RuntimeError, match="inference only"):
        lstm_cuda.lstm_seq_stream(x, wih.requires_grad_(), whh, bias, lens, h0, c0)


@pytest.mark.parametrize("chunk", [1600, 7040])
def test_streaming_matches_jax_and_offline(models, chunk):
    """Chunked greedy tokens equal JAX's StreamingRecognizer's and the
    port's offline greedy decode of the whole waveform (64 frames, 4 blocks
    of 16, so both see the same frames)."""
    jax_cfg, _, params, cfg, model = models
    audio = _audio()
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.full((2,), N))
    ids, n = greedy_ctc(out["ctc_logits"], out["enc_len"])
    offline = [ids[b, :n[b]].tolist() for b in range(2)]
    got = _feed(StreamingRecognizer(model, cfg, batch_size=2, block_frames=16), audio, chunk)
    want = _feed(jax_streaming.StreamingRecognizer(params, jax_cfg, batch_size=2,
                                                   block_frames=16), audio, chunk)
    assert got == want == offline
    assert any(got), "degenerate test: nothing decoded"


def test_state_shapes_reset_and_finish(models):
    _, _, _, cfg, model = models
    state = init_stream_state(cfg, batch_size=3)
    assert [tuple(c.shape) for c in state.conv_ctx] == [(3, 2, 80, 1), (3, 2, 40, 8)]
    assert [tuple(h.shape) for h in state.lstm_h + state.lstm_c] == [(3, 32)] * 4
    assert state.prev_tok.tolist() == [-1] * 3
    rec = StreamingRecognizer(model, cfg, batch_size=2, block_frames=16)
    audio = _audio()
    first = _feed(rec, audio, 4000)
    with pytest.raises(RuntimeError, match="finished"):
        rec.accept(audio[:, :100])
    assert rec.finish() == [[], []]
    rec.reset()
    assert rec.state.prev_tok.tolist() == [-1, -1] and rec._buf.shape == (2, 0)
    assert _feed(rec, audio, 4000) == first


def test_refusals(models):
    _, _, _, cfg, model = models
    for field, value, match in (("bidirectional", True, "bidirectional"),
                                ("causal_conv", False, "causal_conv")):
        bad = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, encoder=dataclasses.replace(cfg.model.encoder, **{field: value})))
        with pytest.raises(ValueError, match=match):
            init_stream_state(bad, 1)
    norm = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, normalize=True))
    with pytest.raises(ValueError, match="normalize"):
        StreamingRecognizer(model, norm, 1)
    with pytest.raises(ValueError, match="multiple"):
        StreamingRecognizer(model, cfg, 1, block_frames=6)
    # Beam mode is ported (tests/test_torch_stream_beam.py); as in JAX, LM
    # options in greedy mode are refused, a bare weight is not, and beam
    # mode takes only a ``HashedNgramLM`` as the hashed LM.
    with pytest.raises(ValueError, match="beam"):
        StreamingRecognizer(model, cfg, 1, lm_table=torch.zeros(2, VOCAB))
    assert StreamingRecognizer(model, cfg, 1, lm_alpha=0.5).mode == "greedy"
    with pytest.raises(TypeError, match="HashedNgramLM"):
        StreamingRecognizer(model, cfg, 1, mode="beam", hash_lm=object())


@pytest.fixture(scope="module")
def step_pair():
    """One train step of the causal config at a small width, JAX and port,
    from the same params and batch (float32 residuals on the port's side)."""
    jcfg = jax_get_config("ctc_bilstm_dev1h", **SMALL)
    cfg = get_config("ctc_bilstm_dev1h", **SMALL)
    batch = next(build_dataset(cfg.data, cfg.frontend.sample_rate).epoch_batches(seed=0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_state.build_model(jcfg)
    jst = jax_state.init_train_state(jcfg, jmodel, batch)
    step_rng = jax.random.split(jax.random.wrap_key_data(jst.rng, impl=jcfg.train.rng_impl))[1]
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_state.compute_losses(jcfg, jmodel, p, jbatch, step_rng, train=True,
                                           step=jst.step), has_aux=True))(jst.params)
    model = set_residual_dtype(port_state.build_model(cfg, torch.device("cpu")), torch.float32)
    model.load_state_dict(weights.load_jax_params(jax.tree.map(np.asarray, jst.params)))
    st = port_state.init_train_state(cfg, model)
    aux = port_state.train_step(cfg, st, port_state.batch_to_device(batch, torch.device("cpu")))
    return jaux, weights.load_jax_params(jax.tree.map(np.asarray, jgrads)), st, aux


def test_causal_train_step_matches_jax(step_pair):
    jaux, jgrads, st, aux = step_pair
    np.testing.assert_allclose(float(aux["ctc_loss"]), float(jaux["ctc_loss"]), rtol=LOSS_RTOL)
    named = dict(st.model.named_parameters())
    assert set(named) == set(jgrads) and not any(".bwd." in k for k in named)
    for name, ref in jgrads.items():
        scale = float(ref.abs().max())
        torch.testing.assert_close(named[name].grad, ref, rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-12),
                                   msg=lambda m, name=name: f"{name}: {m}")
