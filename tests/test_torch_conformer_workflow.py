"""ConformerCTC's zero-shot workflow entry points on the tiny linear
Conformer (test_torch_conformer's configs): ``quantize_encoder_synthetic``
calibrates on synthesized features and the model then serves PTQ, then
frozen; every entry point given no device runs on CUDA or raises.  (The
forward dispatch against the JAX package is test_torch_conformer_calib's.)
"""
import numpy as np
import pytest
import torch

from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig
from test_torch_conformer import FLAGS, _noise_pcm
from test_torch_conformer_calib import _batches, _models


@pytest.fixture(scope="module")
def pair():
    return _models("")


def test_quantize_encoder_synthetic_calibrates(pair):
    _, pm = pair
    losses = pm.quantize_encoder_synthetic(num_batch=1, batch_size=2, seqlen=24, train_iter=3,
                                           device="cpu", percentile=99.9, **FLAGS)
    assert len(losses) == 1 and len(losses[0]) == 3 and np.isfinite(losses[0]).all()
    assert pm.mode() == "ptq"
    assert pm.enc_qcfg == ConformerQuantConfig(percentile=99.9, **FLAGS)
    assert float(pm.enc_qstate["dec_in"]["x_max"]) != 0.0
    tables = pm.freeze(device="cpu")
    assert tables["encoder"]["device"] == torch.device("cpu")


def test_workflow_entry_points_default_to_cuda(pair):
    """device=None means the CUDA device: without a GPU each entry point
    raises instead of running on the CPU."""
    _, pm = pair
    if torch.cuda.is_available():
        assert pm._weights(torch.device("cuda", 0), "float")["decoder"]["w"].is_cuda
        return
    pcm, lens = _noise_pcm(3, 0.5)
    calls = (lambda: pm.quantize_encoder(_batches("")[:1], features=True),
             lambda: pm.quantize_encoder_synthetic(num_batch=1, train_iter=1),
             lambda: pm.forward(pcm, lens), lambda: pm.transcribe_greedy(pcm, lens))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
