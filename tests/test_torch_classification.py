"""The classification and speaker models in the port against the JAX
package (qasr_tpu/models/classification.py), and SqueezeExcite in float.

Pools (masked average / max; stats xvector / gram / superVector), the
classification and speaker heads (the angular output too) and both losses
on seeded inputs within 1e-5 relative; SqueezeExcite with its global and
windowed context in a FloatExec forward within 1e-5; MatchboxNet-3x1x64 at
full width (B=2 x 1 s of seeded audio, through the log-mel frontend)
within rtol 1e-4 of the JAX logits, with equal argmax; SpeakerNet-style
embeddings within 1e-4; ``.qasr`` archives round-trip in the port, the
port reads the JAX package's and the JAX package reads the port's;
``model_from_jax`` carries SE and the heads' params.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import classification as JC
from qasr_tpu.models import jasper as JJ
from qasr_tpu.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu.models.config import matchboxnet3x1x64 as jax_matchboxnet
from qasr_tpu_torch.compat.from_jax import model_from_jax
from qasr_tpu_torch.models import classification as PC
from qasr_tpu_torch.models import jasper as PJ
from qasr_tpu_torch.models.config import matchboxnet3x1x64
from qasr_tpu_torch.quantize.ranges import params_to_device


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol)


def enc_inputs(seed=0, b=3, t=40, c=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    lens = np.asarray([t, t - 13, 1][:b], np.int32)
    return x, lens


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_masked_time_pool(mode):
    x, lens = enc_inputs()
    close(PC.masked_time_pool(torch.from_numpy(x), torch.from_numpy(lens), mode),
          JC.masked_time_pool(jnp.asarray(x), jnp.asarray(lens), mode))


@pytest.mark.parametrize("pool_mode", ["xvector", "gram", "superVector"])
def test_stats_pool(pool_mode):
    x, lens = enc_inputs(1)
    got = PC.stats_pool(torch.from_numpy(x), torch.from_numpy(lens), pool_mode)
    assert got.shape[-1] == PC.stats_pool_feat_dim(16, pool_mode)
    close(got, JC.stats_pool(jnp.asarray(x), jnp.asarray(lens), pool_mode))


@pytest.mark.parametrize("angular", [False, True])
def test_heads_and_losses(angular):
    x, lens = enc_inputs(2)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    labels = np.asarray([1, 0, 2], np.int32)
    cp = JC.init_classification_decoder(3, 16, 5)
    assert all(np.array_equal(a, b) for a, b in zip(
        [cp["linear"]["w"], cp["linear"]["b"]],
        [PC.init_classification_decoder(3, 16, 5)["linear"][k] for k in ("w", "b")]))
    want = JC.classification_decoder(cp, jnp.asarray(x), jnp.asarray(lens))
    got = PC.classification_decoder(params_to_device(cp, "cpu"), xt, lt)
    close(got, want)
    close(PC.classification_decoder(params_to_device(cp, "cpu"), xt, lt, "max", False),
          JC.classification_decoder(cp, jnp.asarray(x), jnp.asarray(lens), "max", False))
    close(PC.cross_entropy_loss(got, torch.from_numpy(labels)),
          JC.cross_entropy_loss(want, jnp.asarray(labels)))
    sp = JC.init_speaker_decoder(4, 16, 3, (24, 12), "superVector", angular)
    pp = PC.init_speaker_decoder(4, 16, 3, (24, 12), "superVector", angular)
    assert PC.stats_pool_feat_dim(16, "superVector") == 16 * 16 + 32
    np.testing.assert_array_equal(pp["final"]["w"], sp["final"]["w"])
    lw, ew = JC.speaker_decoder(sp, jnp.asarray(x), jnp.asarray(lens),
                                pool_mode="superVector", angular=angular)
    lg, eg = PC.speaker_decoder(params_to_device(sp, "cpu"), xt, lt, pool_mode="superVector",
                                angular=angular)
    close(lg, lw)
    close(eg, ew)
    if angular:
        close(PC.angular_softmax_loss(lg, torch.from_numpy(labels)),
              JC.angular_softmax_loss(lw, jnp.asarray(labels)))


@pytest.mark.parametrize("window", [-1, 5])
def test_squeeze_excite_float(window):
    blocks = (BlockConfig(filters=24, repeat=2, kernel=(5,), residual=True, separable=True,
                          se=True, se_reduction_ratio=4, se_context_size=window),
              BlockConfig(filters=32, repeat=1, kernel=(3,), residual=False, se=True))
    cfg = EncoderConfig(feat_in=16, blocks=blocks, activation="relu")
    plan = JJ.build_encoder_plan(cfg)
    params = JJ.init_encoder_params(np.random.default_rng(0), plan)
    pplan = PJ.build_encoder_plan(PJ.EncoderConfig.from_dict(
        {"feat_in": 16, "activation": "relu",
         "jasper": [dict(filters=24, repeat=2, kernel=[5], residual=True, separable=True,
                         se=True, se_reduction_ratio=4, se_context_size=window),
                    dict(filters=32, repeat=1, kernel=[3], residual=False, se=True)]}))
    assert dataclasses.astuple(pplan) == dataclasses.astuple(plan)
    pparams = PJ.init_encoder_params(np.random.default_rng(0), pplan)
    np.testing.assert_array_equal(pparams["blocks"][0]["se"]["fc1"], params["blocks"][0]["se"]["fc1"])
    x, lens = enc_inputs(5, b=2, t=29)
    want, _ = JJ.encoder_forward(JJ.FloatExec(params, activation="relu"), plan,
                                 jnp.asarray(x), jnp.asarray(lens))
    got, _ = PJ.encoder_forward(PJ.FloatExec(params_to_device(pparams, "cpu"),
                                             activation="relu"),
                                pplan, torch.from_numpy(x), torch.from_numpy(lens))
    close(got, want)
    qx = PJ.QuantExec(params_to_device(PJ.fold_bn_encoder(pparams), "cpu"),
                      {"blocks": [], "decoder_act": {}}, PJ.QuantConfig(), activation="relu",
                      update_ranges=False)
    with pytest.raises(NotImplementedError, match="SqueezeExcite"):
        qx.squeeze_excite(0, None, pplan.blocks[0])


def seeded_audio(b=2, seconds=1.0, seed=9):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    x = (rng.normal(size=(b, n)) * 0.1).astype(np.float32)
    x[1, int(n * 0.7):] = 0.0
    return x, np.asarray([n, int(n * 0.7)], np.int32)


@pytest.fixture(scope="module")
def matchbox():
    jm = JC.EncDecClassificationModel.from_config(jax_matchboxnet(), num_classes=2,
                                                  labels=("background", "speech"))
    pm = PC.EncDecClassificationModel.from_config(matchboxnet3x1x64(), num_classes=2,
                                                  labels=("background", "speech"))
    return jm, pm


def test_matchboxnet_full_width_logits_match_jax(matchbox):
    """MatchboxNet-3x1x64 at full width (its published widths; random
    weights from seed 0), B=2 x 1 s: logits within rtol 1e-4, equal
    predictions."""
    jm, pm = matchbox
    assert dataclasses.astuple(pm.plan) == dataclasses.astuple(jm.plan)
    assert pm.plan.feat_out == 128
    audio, lens = seeded_audio()
    want = np.asarray(jm.logits(jm.params, jnp.asarray(audio), jnp.asarray(lens)))
    got = pm.logits(audio, lens, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(pm.predict(audio, lens, device="cpu"), want.argmax(-1))
    loss = pm.loss_fn(audio, lens, np.asarray([1, 0]), device="cpu")
    close(loss, JC.cross_entropy_loss(jnp.asarray(want), jnp.asarray([1, 0])), 1e-4)


def test_qasr_archives_both_ways(matchbox, tmp_path):
    jm, pm = matchbox
    audio, lens = seeded_audio(seconds=0.5)
    want = pm.logits(audio, lens, device="cpu")
    p_path, j_path = str(tmp_path / "port.qasr"), str(tmp_path / "jax.qasr")
    pm.save_to(p_path)
    back = PC.EncDecClassificationModel.restore_from(p_path)
    assert back.labels == pm.labels and back.num_classes == 2 and back.pooling == "avg"
    assert torch.equal(back.logits(audio, lens, device="cpu"), want)
    jm.save_to(j_path)
    from_jax = PC.EncDecClassificationModel.restore_from(j_path)
    assert torch.equal(from_jax.logits(audio, lens, device="cpu"), want)
    j_back = JC.EncDecClassificationModel.restore_from(p_path)
    assert j_back.labels == ("background", "speech")
    with pytest.raises(ValueError, match="not a speaker checkpoint"):
        PC.EncDecSpeakerLabelModel.restore_from(p_path)


def test_speaker_embeddings_and_archives(tmp_path):
    blocks = (BlockConfig(filters=32, repeat=1, kernel=(11,), residual=False, separable=True),
              BlockConfig(filters=32, repeat=2, kernel=(5,), residual=True, separable=True,
                          se=True),
              BlockConfig(filters=48, repeat=1, kernel=(1,), residual=False))
    jcfg = ModelConfig(encoder=EncoderConfig(feat_in=64, blocks=blocks),
                       decoder=DecoderConfig(feat_in=48, num_classes=4),
                       preprocessor={"features": 64, "n_fft": 512, "dither": 0.0})
    jm = JC.EncDecSpeakerLabelModel.from_config(jcfg, num_speakers=4, emb_sizes=(32, 16),
                                                pool_mode="xvector", angular=True)
    pm = model_from_jax(jm)
    assert isinstance(pm, PC.EncDecSpeakerLabelModel) and pm.angular
    np.testing.assert_array_equal(pm.params["encoder"]["blocks"][1]["se"]["fc2"],
                                  np.asarray(jm.params["encoder"]["blocks"][1]["se"]["fc2"]))
    audio, lens = seeded_audio(seconds=0.5, seed=3)
    want = jm.embeddings(audio, lens)
    got = pm.embeddings(audio, lens, device="cpu")
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    path = str(tmp_path / "spk.qasr")
    pm.save_to(path)
    back = PC.EncDecSpeakerLabelModel.restore_from(path)
    np.testing.assert_array_equal(back.embeddings(audio, lens, device="cpu"), got)
    jm.save_to(str(tmp_path / "jspk.qasr"))
    np.testing.assert_array_equal(PC.EncDecSpeakerLabelModel.restore_from(
        str(tmp_path / "jspk.qasr")).embeddings(audio, lens, device="cpu"), got)
    cm = model_from_jax(JC.EncDecClassificationModel.from_config(jcfg, num_classes=3))
    assert cm.params["decoder"]["linear"]["w"].shape == (48, 3)
