"""The port's training CLIs on the CPU (``--device cpu``) on a tiny YAML.

(a) cli.speech_to_text: 2 steps on a 4-wav manifest write step_1.npz,
    step_2.npz and last.npz (the JAX package's layout: params/, opt/<i>,
    step), metrics.jsonl, run_config.yaml and TensorBoard events; run again
    at the same max_steps it resumes from last.npz and writes back params
    and optimizer state equal to the saved ones bit for bit; at max_steps 3
    it takes one more step from there.  The checkpoint loads in the JAX
    package (its load_training_ckpt, against its own trainer's templates).
(b) cli.speech_to_text_rnnt: 2 steps with a validation manifest print a
    finite loss and a WER.
(c) Without --device both CLIs run on the CUDA device or raise.
"""
import json
import os

import numpy as np
import pytest

from qasr_tpu.data.audio import write_wav
from qasr_tpu_torch.cli import speech_to_text, speech_to_text_rnnt
from qasr_tpu_torch.models.config import DEFAULT_LABELS
from qasr_tpu_torch.utils.yaml_io import safe_dump

BLOCKS = [{"filters": 24, "repeat": 1, "kernel": [7], "stride": [2], "dilation": [1],
           "dropout": 0.0, "residual": False, "separable": True},
          {"filters": 32, "repeat": 1, "kernel": [1], "stride": [1], "dilation": [1],
           "dropout": 0.0, "residual": False}]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    path = d / "train.json"
    with open(path, "w") as f:
        for i, text in enumerate(["hello world", "the cat", "a dog ran", "sun"]):
            wav = d / f"u{i}.wav"
            write_wav(str(wav), (rng.normal(size=8000 + 800 * i) * 0.05).astype(np.float32))
            f.write(json.dumps({"audio_filepath": str(wav), "duration": (8000 + 800 * i) / 16000,
                                "text": text}) + "\n")
    return str(path)


def _yaml(tmp_path, manifest, exp_dir):
    cfg = {"model": {"sample_rate": 16000, "labels": list(DEFAULT_LABELS),
                     "train_ds": {"manifest_filepath": manifest, "batch_size": 2,
                                  "shuffle": False},
                     "preprocessor": {"features": 16, "dither": 0.0},
                     "encoder": {"feat_in": 16, "activation": "relu", "jasper": BLOCKS},
                     "decoder": {"feat_in": 32, "num_classes": 28},
                     "optim": {"name": "novograd", "lr": 0.01,
                               "sched": {"name": "CosineAnnealing", "warmup_steps": 0}}},
           "trainer": {"max_steps": 2},
           "exp_manager": {"exp_dir": exp_dir, "name": "tiny", "checkpoint_every_n_steps": 1,
                           "resume_if_exists": True, "resume_ignore_no_checkpoint": True}}
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        safe_dump(cfg, f)
    return str(path)


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_speech_to_text_trains_checkpoints_and_resumes(tmp_path, manifest):
    exp = str(tmp_path / "exp")
    cfg = _yaml(tmp_path, manifest, exp)
    tr = speech_to_text.main(["--config-path", cfg, "--device", "cpu"])
    assert tr.step == 2
    root = os.path.join(exp, "tiny", "version_0")
    ck = os.path.join(root, "checkpoints")
    assert sorted(os.listdir(ck)) == ["last.npz", "step_1.npz", "step_2.npz"]
    assert os.path.exists(os.path.join(root, "metrics.jsonl"))
    assert os.path.exists(os.path.join(root, "run_config.yaml"))
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(root))
    saved = _arrays(os.path.join(ck, "last.npz"))
    assert int(saved["step"]) == 2 and any(k.startswith("opt/") for k in saved)

    tr2 = speech_to_text.main(["--config-path", cfg, "--device", "cpu"])   # resumes, no step
    assert tr2.step == 2
    again = _arrays(os.path.join(ck, "last.npz"))
    assert sorted(again) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(again[k], saved[k], err_msg=k)

    tr3 = speech_to_text.main(["--config-path", cfg, "--device", "cpu", "trainer.max_steps=3"])
    assert tr3.step == 3 and int(_arrays(os.path.join(ck, "last.npz"))["step"]) == 3

    # the port's checkpoint loads in the JAX package
    from qasr_tpu.models.config import ModelConfig as JModel
    from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
    from qasr_tpu.train.trainer import TrainConfig as JTC
    from qasr_tpu.train.trainer import Trainer as JaxTrainer
    from qasr_tpu.utils.checkpoint import load_training_ckpt
    from qasr_tpu_torch.models.config import config_to_dict

    jm = JaxASRModel.from_config(JModel.from_dict(config_to_dict(tr.model.cfg)))
    jt = JaxTrainer(jm, JTC(warmup_steps=0))
    params, _, step, _ = load_training_ckpt(os.path.join(ck, "step_2.npz"), jm.params,
                                            jt.opt_state)
    assert step == 2
    np.testing.assert_array_equal(np.asarray(params["decoder"]["w"]),
                                  saved["params/decoder/w"])


def test_speech_to_text_rnnt_trains(tmp_path, manifest, capsys):
    cfg = tmp_path / "rnnt.yaml"
    with open(cfg, "w") as f:
        safe_dump({"model": {"labels": list(DEFAULT_LABELS),
                             "preprocessor": {"features": 16, "dither": 0.0},
                             "encoder": {"feat_in": 16, "activation": "relu", "jasper": BLOCKS},
                             "decoder": {"feat_in": 32, "num_classes": 28}}}, f)
    out = speech_to_text_rnnt.main(["--config", str(cfg), "--train_manifest", manifest,
                                    "--val_manifest", manifest, "--batch_size", "2",
                                    "--max_steps", "2", "--pred_hidden", "16",
                                    "--joint_hidden", "16", "--device", "cpu"])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert np.isfinite(out["val_wer"])
    printed = capsys.readouterr().out
    assert "final loss:" in printed and "val WER:" in printed


def test_clis_default_to_cuda(tmp_path, manifest):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CLIs would run on it")
    cfg = _yaml(tmp_path, manifest, str(tmp_path / "exp"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        speech_to_text.main(["--config-path", cfg])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        speech_to_text_rnnt.main(["--config", cfg, "--train_manifest", manifest])
