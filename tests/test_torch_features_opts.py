"""The port's frontends in every option the JAX MelFrontend takes, against
the JAX package on the same audio (qasr_tpu/ops/features.py).

Options: normalize per_feature / all_features / fixed mean and std (a (C,)
vector and a (B, C) table) / none / empty; pad_to a multiple, 0, or "max"
(shorter input padded to max_duration's frames, longer input truncated);
mag_power 1 and 2; log off; log_zero_guard_type clamp; the "tiny" and
"eps" guard values (any other string raises ValueError); stft_matmul (the
TPU's DFT lowering: the same STFT here); frame_splicing (taken, not
applied, as the JAX frontend); the MFCC frontend (DCT-II) and
crop_or_pad_spectrogram.  Every preprocessor key the JAX mapper takes
reaches the port's FeatureConfig.

Tolerance (the frontend's float tolerance, as tests/test_torch_slice.py):
lengths equal, |port - JAX| at most 1e-3 and 1e-4 on average, relative to
max(1, |JAX|) (log-free and MFCC outputs are not O(1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models.config import preprocessor_config_from_dict as jax_prep
from qasr_tpu.ops import features as JF
from qasr_tpu_torch.models.config import preprocessor_config_from_dict as port_prep
from qasr_tpu_torch.ops import features as PF

FIXED_C = {"fixed_mean": np.linspace(-3.0, 1.0, 40).tolist(),
           "fixed_std": np.linspace(0.5, 2.0, 40).tolist()}
FIXED_BC = {"fixed_mean": np.full((2, 40), -2.0).tolist(),
            "fixed_std": np.linspace(1.0, 2.0, 80).reshape(2, 40).tolist()}

OPTIONS = {
    "per_feature": {},
    "all_features": {"normalize": "all_features"},
    "fixed (C,)": {"normalize": FIXED_C},
    "fixed (B, C)": {"normalize": FIXED_BC},
    "normalize none": {"normalize": None},
    "normalize empty": {"normalize": ""},
    "pad_to 0": {"pad_to": 0},
    "pad_to max, shorter input": {"pad_to": "max", "max_duration": 0.9},
    "pad_to max, longer input": {"pad_to": "max", "max_duration": 0.33},
    "mag_power 1": {"mag_power": 1.0},
    "log off": {"log": False, "normalize": "all_features"},
    "clamp guard": {"log_zero_guard_type": "clamp"},
    "tiny guard": {"log_zero_guard_value": "tiny"},
    "eps guard, clamp": {"log_zero_guard_value": "eps", "log_zero_guard_type": "clamp"},
    "stft_matmul": {"stft_matmul": True},
    "frame_splicing 3": {"frame_splicing": 3},
    "hamming, no preemph": {"window": "hamming", "preemph": 0.0, "window_size": 0.025},
}


def audio():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32)
    x[1, 5600:] = 0.0
    # a silent stretch: the log guards matter there
    x[0, 1000:2600] = 0.0
    return x, np.asarray([8000, 5600], np.int32)


def cfgs(opts):
    d = {"features": 40, "n_fft": 512, "dither": 0.0, **opts}
    return JF.FeatureConfig(**d), PF.FeatureConfig(**d)


def close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 1e-3 and err.mean() <= 1e-4, (err.max(), err.mean())


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_mel_frontend_option_matches_jax(name):
    jc, pc = cfgs(OPTIONS[name])
    x, lens = audio()
    fj, lj = JF.MelFrontend(jc)(jnp.asarray(x), jnp.asarray(lens), dither=0.0)
    fp, lp = PF.MelFrontend(pc)(torch.from_numpy(x), torch.from_numpy(lens), dither=0.0)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    close(fp.numpy(), np.asarray(fj))
    if OPTIONS[name].get("pad_to") == "max":
        assert fp.shape[1] == PF.MelFrontend(pc).max_length


def test_mfcc_frontend_and_dct_match_jax():
    jc, pc = cfgs({})
    np.testing.assert_array_equal(PF.dct_matrix(13, 40), JF.dct_matrix(13, 40))
    x, lens = audio()
    fj, lj = JF.MFCCFrontend(jc, n_mfcc=13)(jnp.asarray(x), jnp.asarray(lens), dither=0.0)
    fp, lp = PF.MFCCFrontend(pc, n_mfcc=13)(torch.from_numpy(x), torch.from_numpy(lens),
                                            dither=0.0)
    assert fp.shape[-1] == 13
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    close(fp.numpy(), np.asarray(fj))


@pytest.mark.parametrize("target", [30, 64, 101])
def test_crop_or_pad_spectrogram_matches_jax(target):
    rng = np.random.default_rng(target)
    x = rng.normal(size=(2, 64, 8)).astype(np.float32)
    lens = np.asarray([64, 40], np.int32)
    xj, lj = JF.crop_or_pad_spectrogram(jnp.asarray(x), jnp.asarray(lens), target, -1.0)
    xp, lp = PF.crop_or_pad_spectrogram(torch.from_numpy(x), torch.from_numpy(lens), target,
                                        -1.0)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))


def test_guard_strings_and_modes_refused():
    with pytest.raises(ValueError, match="'tiny' or 'eps'"):
        PF.MelFrontend(PF.FeatureConfig(log_zero_guard_value="huge"))
    with pytest.raises(ValueError, match="'tiny' or 'eps'"):
        JF.MelFrontend(JF.FeatureConfig(log_zero_guard_value="huge"))
    with pytest.raises(NotImplementedError):
        PF.MelFrontend(PF.FeatureConfig(normalize="per_utterance"))
    with pytest.raises(NotImplementedError):
        PF.MelFrontend(PF.FeatureConfig(normalize={"fixed_mean": [0.0]}))


def test_preprocessor_keys_reach_the_config():
    """Every key the JAX mapper takes (NeMo's YAML names) lands in the
    port's FeatureConfig with the same value; _target_ is ignored."""
    d = {"_target_": "nemo.collections.asr.modules.AudioToMelSpectrogramPreprocessor",
         "features": 80, "sample_rate": 8000, "window_size": 0.025, "window_stride": 0.02,
         "window": "hamming", "normalize": "all_features", "n_fft": 256, "preemph": 0.9,
         "dither": 0.0, "pad_to": "max", "pad_value": -1.0, "mag_power": 1.0,
         "lowfreq": 20.0, "highfreq": 3800.0, "log": False, "frame_splicing": 2,
         "max_duration": 5.0, "log_zero_guard_type": "clamp", "log_zero_guard_value": "eps"}
    jc, pc = jax_prep(dict(d)), port_prep(dict(d))
    for k in d:
        if k != "_target_":
            assert getattr(pc, k) == getattr(jc, k) == d[k], k
