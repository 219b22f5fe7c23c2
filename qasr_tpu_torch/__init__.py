"""QASR port to PyTorch and CUDA: integer-only QuartzNet and Conformer-CTC
serving on Hopper.

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
