"""QASR port to PyTorch and CUDA: integer-only QuartzNet, Jasper,
Conformer-CTC and Conformer-Transducer serving on Hopper.

The JAX package ``qasr_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``quantize/``, ``kernels/``) and imports
nothing of it, nor jax: it keeps its own copies of the host modules it
needs (model configs, CTC decoding, audio input, the range assets).

    from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
    model = ASRModel.from_pretrained("QuartzNet15x5Base-En",
                                     allow_random_weights=True)
    model.set_quant_bit(6, "weight"); model.set_quant_bit(6, "act")
    model.bn_folding(); model.qstate_from_json(text)
    fn = make_frozen_fn(model, model.freeze(device=dev), argmax=True)
    ids, enc_lens = fn(pcm_int16, lengths)
"""
__version__ = "0.1.0"

# names resolved at first use (``qasr_tpu_torch.StreamingTranscriber``), so
# that importing the package stays light
_LAZY = {
    "StreamingTranscriber": "qasr_tpu_torch.decode.streaming",
    "CacheAwareConformerStream": "qasr_tpu_torch.decode.streaming",
    "StreamingTransducer": "qasr_tpu_torch.decode.streaming",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'qasr_tpu_torch' has no attribute {name!r}")
