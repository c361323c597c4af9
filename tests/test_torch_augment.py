"""The port's waveform augmentation (config 5) against the JAX package on the
CPU.  JAX draws from its key chain inside each function; the test makes the
same draws with ``jax.random`` from the same keys and passes them to the
port's functions, which take their draws as tensors.  Then the model's
train-mode ``encode`` is held to the augmentation it draws."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_asr_tpu.frontend import augment as jax_aug
from pytorch_asr_tpu_torch.configs import get_config
from pytorch_asr_tpu_torch.frontend import augment
from pytorch_asr_tpu_torch.models.asr_model import ASRModel

SR = 16000
# float32 both sides; the lerp is the same expression (bit-equal here), the
# noise's power sums in another order and 10**x may round one ulp apart.
TOL = 1e-6
NOISE_RTOL = 1e-5


def _audio(seed=0, B=4, A=8000):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((B, A)).astype(np.float32) * 0.3
    lens = np.array([A, 6000, 3001, 0], np.int32)[:B]
    for b, n in enumerate(lens):
        audio[b, n:] = 0.0
    return audio, lens


def _jax_draws(key, B, A, cfg: jax_aug.WaveformAugmentConfig) -> dict:
    """The draws ``augment_waveform`` makes from ``key``, as numpy arrays."""
    k_speed, k_gain, k_noise = jax.random.split(key, 3)
    k_snr, k_n = jax.random.split(k_noise)
    return {"factor": jax.random.uniform(k_speed, (B, 1), minval=cfg.speed_range[0],
                                         maxval=cfg.speed_range[1]),
            "gain_db": jax.random.uniform(k_gain, (B, 1), minval=cfg.gain_db_range[0],
                                          maxval=cfg.gain_db_range[1]),
            "snr_db": jax.random.uniform(k_snr, (B,), minval=cfg.noise_snr_db_range[0],
                                         maxval=cfg.noise_snr_db_range[1]),
            "noise": jax.random.normal(k_n, (B, A), jnp.float32)}


def _t(draws: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("lo,hi", [(0.85, 1.15), (0.8, 0.9), (1.1, 1.2)])
def test_speed_perturb_matches_jax(lo, hi):
    """Slow-downs on the full row clamp to len / A; the others stretch or
    shrink; lengths truncate; the tail past the new length is 0."""
    audio, lens = _audio()
    key = jax.random.PRNGKey(7)
    ref, ref_len = jax_aug.speed_perturb(key, jnp.asarray(audio), jnp.asarray(lens), lo, hi)
    factor = jax.random.uniform(key, (4, 1), minval=lo, maxval=hi)
    got, got_len = augment.speed_perturb(torch.from_numpy(audio), torch.from_numpy(lens),
                                         torch.from_numpy(np.array(factor)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert got_len.dtype == torch.int32 and got_len[3] == 0


def test_speed_perturb_shifts_a_sine():
    """A 440 Hz sine sped up by 1.1 peaks at 484 Hz over its new length."""
    n = SR
    audio = torch.sin(2 * torch.pi * 440.0 * torch.arange(n) / SR)[None, :]
    out, new_len = augment.speed_perturb(audio, torch.tensor([n]), torch.tensor([[1.1]]))
    assert abs(int(new_len[0]) - int(n / 1.1)) <= 1
    seg = out[0, : int(new_len[0])].numpy()
    assert abs(np.argmax(np.abs(np.fft.rfft(seg))) * SR / len(seg) - 484.0) < 5.0
    assert not out[0, int(new_len[0]):].any()


def test_gain_and_noise_match_jax():
    audio, lens = _audio(1)
    key = jax.random.PRNGKey(3)
    ref = jax_aug.gain_perturb(key, jnp.asarray(audio), -6.0, 6.0)
    db = jax.random.uniform(key, (4, 1), minval=-6.0, maxval=6.0)
    got = augment.gain_perturb(torch.from_numpy(audio), torch.from_numpy(np.array(db)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    ref = jax_aug.noise_inject(key, jnp.asarray(audio), jnp.asarray(lens), 15.0, 40.0)
    k_snr, k_n = jax.random.split(key)
    snr = jax.random.uniform(k_snr, (4,), minval=15.0, maxval=40.0)
    noise = jax.random.normal(k_n, audio.shape, jnp.float32)
    got = augment.noise_inject(torch.from_numpy(audio), torch.from_numpy(lens),
                               torch.from_numpy(np.array(snr)), torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=NOISE_RTOL, atol=TOL)
    assert torch.equal(got[3], torch.zeros(audio.shape[1]))       # the empty row
    assert torch.equal(got[2, 3001:], torch.zeros(audio.shape[1] - 3001))


def test_augment_waveform_chain_matches_jax():
    """Speed, then gain, then noise over the new lengths: the whole chain
    with the draws JAX makes from one key."""
    audio, lens = _audio(2)
    cfg = jax_aug.WaveformAugmentConfig()
    key = jax.random.PRNGKey(11)
    ref, ref_len = jax_aug.augment_waveform(key, jnp.asarray(audio), jnp.asarray(lens), cfg)
    got, got_len = augment.apply_augment(torch.from_numpy(audio), torch.from_numpy(lens),
                                         _t(_jax_draws(key, *audio.shape, cfg)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=NOISE_RTOL, atol=TOL)


def test_draws_fall_in_their_ranges():
    cfg = augment.WaveformAugmentConfig()
    d = augment.draw_augment(torch.Generator().manual_seed(0), 64, 10, cfg, "cpu")
    assert d["factor"].shape == d["gain_db"].shape == (64, 1) and d["snr_db"].shape == (64,)
    for key, (lo, hi) in (("factor", cfg.speed_range), ("gain_db", cfg.gain_db_range),
                          ("snr_db", cfg.noise_snr_db_range)):
        assert lo <= float(d[key].min()) and float(d[key].max()) <= hi, key
    assert d["noise"].shape == (64, 10) and abs(float(d["noise"].mean())) < 0.2


def test_encode_augments_in_train_mode_only():
    """Config 5's frontend: in train mode ``encode`` runs the features of the
    augmented waveform drawn from the generator, with the new lengths; in
    eval mode it leaves the waveform as it is."""
    cfg = get_config("joint_ctc_attention_960h", **{
        "model.encoder.hidden_dim": "8", "model.encoder.num_layers": "1",
        "model.encoder.conv_channels": "2,2", "model.encoder.dropout": "0.0",
        "model.compute_dtype": "float32", "frontend.specaugment": "false"})
    assert cfg.frontend.waveform_augment
    model = ASRModel(cfg.frontend, cfg.model, 31)
    audio, lens = (torch.from_numpy(x) for x in _audio(3))
    with torch.no_grad():
        enc, enc_len = model.encode(audio, lens, train=True,
                                    generator=torch.Generator().manual_seed(5))
        wa = augment.WaveformAugmentConfig(speed_range=cfg.frontend.wa_speed_range,
                                           gain_db_range=cfg.frontend.wa_gain_db,
                                           noise_snr_db_range=cfg.frontend.wa_noise_snr_db)
        draws = augment.draw_augment(torch.Generator().manual_seed(5), *audio.shape, wa, "cpu")
        aug, aug_len = augment.apply_augment(audio, lens, draws)
        want, want_len = model.encoder(*model.compute_features(aug, aug_len), False, None)
        plain, plain_len = model.encode(audio, lens, train=False)
        ref, ref_len = model.encoder(*model.compute_features(audio, lens), False, None)
    assert torch.equal(enc_len, want_len) and torch.equal(enc, want)
    assert not torch.equal(aug_len, lens)
    assert torch.equal(plain_len, ref_len) and torch.equal(plain, ref)
