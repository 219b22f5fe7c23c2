"""Model configuration schemas of the port (a copy of the parts of
qasr_tpu/models/config.py the port uses; the port imports nothing of the
JAX package).

Dataclass mirrors of NeMo's YAML schema: BlockConfig (JasperEncoderConfig),
EncoderConfig (ConvASREncoderConfig), DecoderConfig (ConvASRDecoderConfig),
ModelConfig, and the QuartzNet / Jasper / MatchboxNet presets, with the
JAX package's field names and defaults (``dataclasses.asdict`` of the two
compare equal); ``register_preset`` adds one by name; and QuantConfig, the
quantization knobs of the inference CLI.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

DEFAULT_LABELS = [
    " ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
    "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "'",
]


@dataclass(frozen=True)
class BlockConfig:
    filters: int
    repeat: int = 3
    kernel: Tuple[int, ...] = (11,)
    stride: Tuple[int, ...] = (1,)
    dilation: Tuple[int, ...] = (1,)
    dropout: float = 0.0
    residual: bool = True
    groups: int = 1
    separable: bool = False
    heads: int = -1
    residual_mode: str = "add"
    residual_dense: bool = False
    se: bool = False
    se_reduction_ratio: int = 8
    se_context_size: int = -1
    se_interpolation_mode: str = "nearest"
    kernel_size_factor: float = 1.0
    stride_last: bool = False


@dataclass(frozen=True)
class EncoderConfig:
    feat_in: int
    blocks: Tuple[BlockConfig, ...]
    activation: str = "relu"
    normalization_mode: str = "batch"
    residual_mode: str = "add"
    norm_groups: int = -1
    conv_mask: bool = True
    frame_splicing: int = 1
    init_mode: str = "xavier_uniform"
    quant_mode: str = "symmetric"
    quant_bit: int = 8


@dataclass(frozen=True)
class DecoderConfig:
    feat_in: int
    num_classes: int
    vocabulary: Tuple[str, ...] = tuple(DEFAULT_LABELS)
    init_mode: str = "xavier_uniform"
    quant_mode: str = "symmetric"
    quant_bit: int = 8


@dataclass(frozen=True)
class QuantConfig:
    """Runtime quantization knobs (the JAX QuantConfig's fields and
    defaults; the frozen tables read only the bits)."""

    mode: str = "symmetric"       # 'none' | 'symmetric'
    weight_bit: int = 8
    act_bit: int = 8
    percentile: Optional[float] = None
    dynamic: bool = False
    act_momentum: float = 0.95    # the EMA of the running ranges; -1: min / max
    # calibration requants: False = float32 multiplier (ranges are all that
    # calibration produces); True = the exact dyadic requant on in-graph
    # float32-frexp mantissas
    calib_exact: bool = False


@dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig
    decoder: DecoderConfig
    preprocessor: dict = field(default_factory=dict)
    spec_augment: Optional[dict] = None
    labels: Tuple[str, ...] = tuple(DEFAULT_LABELS)
    sample_rate: int = 16000
    tokenizer: Optional[dict] = None


# ---------------------------------------------------------------------------
# Presets (NeMo's model cards)
# ---------------------------------------------------------------------------


def _qn_block(filters, kernel, repeat, residual, stride=1, separable=True, **kw):
    return BlockConfig(filters=filters, kernel=(kernel,), repeat=repeat,
                       residual=residual, stride=(stride,), separable=separable,
                       dropout=kw.pop("dropout", 0.0), **kw)


def _ctc_config(blocks, feat_in: int = 64, num_classes: int = len(DEFAULT_LABELS),
                **prep) -> ModelConfig:
    enc = EncoderConfig(feat_in=feat_in, blocks=tuple(blocks), activation="relu")
    dec = DecoderConfig(feat_in=blocks[-1].filters, num_classes=num_classes)
    return ModelConfig(encoder=enc, decoder=dec,
                       preprocessor={"features": feat_in, "n_fft": 512, **prep,
                                     "dither": 1e-5})


def quartznet15x5() -> ModelConfig:
    """QuartzNet15x5 (NeMo conf/quartznet_15x5.yaml)."""
    ks = [33, 33, 33, 33, 39, 39, 39, 51, 51, 51, 63, 63, 63, 75, 75, 75]
    blocks = [_qn_block(256, 33, 1, False, stride=2)]
    blocks += [_qn_block(256, k, 5, True) for k in ks[1:7]]
    blocks += [_qn_block(512, k, 5, True) for k in ks[7:]]
    blocks.append(_qn_block(512, 87, 1, False, dilation=(2,)))
    blocks.append(_qn_block(1024, 1, 1, False, separable=False))
    return _ctc_config(blocks)


def quartznet5x5() -> ModelConfig:
    """QuartzNet5x5LS: one block per kernel group."""
    blocks = [_qn_block(256, 33, 1, False, stride=2)]
    for k, f in [(33, 256), (39, 256), (51, 512), (63, 512), (75, 512)]:
        blocks.append(_qn_block(f, k, 5, True))
    blocks.append(_qn_block(512, 87, 1, False, dilation=(2,)))
    blocks.append(_qn_block(1024, 1, 1, False, separable=False))
    return _ctc_config(blocks)


def jasper10x5dr() -> ModelConfig:
    """Jasper10x5Dr (NeMo conf/jasper_10x5dr.yaml): dense residual."""
    spec = [
        (256, 11, 1, False, 0.2, 2, 1, False),
        (256, 11, 5, True, 0.2, 1, 1, True), (256, 11, 5, True, 0.2, 1, 1, True),
        (384, 13, 5, True, 0.2, 1, 1, True), (384, 13, 5, True, 0.2, 1, 1, True),
        (512, 17, 5, True, 0.2, 1, 1, True), (512, 17, 5, True, 0.2, 1, 1, True),
        (640, 21, 5, True, 0.3, 1, 1, True), (640, 21, 5, True, 0.3, 1, 1, True),
        (768, 25, 5, True, 0.3, 1, 1, True), (768, 25, 5, True, 0.3, 1, 1, True),
        (896, 29, 1, False, 0.4, 1, 2, False),
        (1024, 1, 1, False, 0.4, 1, 1, False),
    ]
    return _ctc_config([
        BlockConfig(filters=f, kernel=(k,), repeat=r, residual=res, dropout=dr,
                    stride=(s,), dilation=(d,), separable=False, residual_dense=dense)
        for f, k, r, res, dr, s, d, dense in spec])


def matchboxnet3x1x64() -> ModelConfig:
    """MatchboxNet 3x1x64 (NeMo conf/matchboxnet_3x1x64_v1.yaml)."""
    blocks = (
        _qn_block(128, 11, 1, False),
        _qn_block(64, 13, 1, True), _qn_block(64, 15, 1, True),
        _qn_block(64, 17, 1, True),
        _qn_block(128, 29, 1, False, dilation=(2,)),
        _qn_block(128, 1, 1, False, separable=False),
    )
    return _ctc_config(blocks, num_classes=30, window_size=0.025)


PRESETS = {
    "QuartzNet15x5Base-En": quartznet15x5,
    "QuartzNet15x5NR-En": quartznet15x5,
    "QuartzNet15x5": quartznet15x5,
    "QuartzNet5x5LS-En": quartznet5x5,
    "Jasper10x5Dr-En": jasper10x5dr,
    "Jasper10x5Dr": jasper10x5dr,
    "MatchboxNet-3x1x64": matchboxnet3x1x64,
}


def register_preset(name: str, factory) -> None:
    """Register a model factory (returning a ModelConfig) under a
    pretrained-style name."""
    PRESETS[name] = factory
