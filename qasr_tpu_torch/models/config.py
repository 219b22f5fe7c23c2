"""Model configuration schemas of the port (a copy of
qasr_tpu/models/config.py; the port imports nothing of the JAX package).

Dataclass mirrors of NeMo's YAML schema: BlockConfig (JasperEncoderConfig),
EncoderConfig (ConvASREncoderConfig), DecoderConfig (ConvASRDecoderConfig),
ModelConfig, and the QuartzNet / Jasper / MatchboxNet presets, with the
JAX package's field names and defaults (``dataclasses.asdict`` of the two
compare equal); ``register_preset`` adds one by name; and QuantConfig, the
quantization knobs of the inference CLI.  ``ModelConfig.from_yaml`` /
``from_dict`` read NeMo's model YAML (``resolve_interpolations`` resolves
its ``${a.b}`` references) and ``config_to_dict`` writes it back, as the
archives store it (through ``utils/yaml_io.py``: no PyYAML).
"""
from __future__ import annotations

import dataclasses
import re
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

    @classmethod
    def from_dict(cls, d: dict) -> "BlockConfig":
        d = dict(d)
        d.pop("se_context_window", None)
        for k in ("kernel", "stride", "dilation"):
            if k in d:
                v = d[k]
                d[k] = tuple(v) if isinstance(v, (list, tuple)) else (v,)
        return cls(**_known(cls, d))


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

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        d = dict(d)
        d.pop("_target_", None)
        blocks = tuple(BlockConfig.from_dict(b) for b in d.pop("jasper"))
        return cls(blocks=blocks, **_known(cls, d))


@dataclass(frozen=True)
class DecoderConfig:
    feat_in: int
    num_classes: int
    vocabulary: Tuple[str, ...] = tuple(DEFAULT_LABELS)
    init_mode: str = "xavier_uniform"
    quant_mode: str = "symmetric"
    quant_bit: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "DecoderConfig":
        d = dict(d)
        d.pop("_target_", None)
        if d.get("vocabulary"):
            d["vocabulary"] = tuple(d["vocabulary"])
        return cls(**_known(cls, d))


def preprocessor_config_from_dict(d: dict):
    """NeMo preprocessor YAML keys -> the port's FeatureConfig
    (ops/features.py): every key the JAX package's mapper takes (features,
    sample_rate, window_size / stride, window, normalize, n_fft, preemph,
    dither, pad_to, pad_value, mag_power, lowfreq / highfreq, log,
    frame_splicing, max_duration and the log guard's type and value);
    ``_target_`` and other keys are ignored."""
    from qasr_tpu_torch.ops.features import preprocessor_config_from_dict as from_dict

    return from_dict(d)


def _known(cls, d: dict) -> dict:
    """The entries of ``d`` that name fields of ``cls``."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class QuantConfig:
    """Runtime quantization knobs (the JAX QuantConfig's fields and
    defaults; the frozen tables read only the bits)."""

    mode: str = "symmetric"       # 'none' | 'symmetric'
    weight_bit: int = 8
    act_bit: int = 8
    bias_bit: int = 32
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
    # a BPE model's tokenizer section ({'type': 'bpe', 'model_path': ...});
    # model_path may name an archive artifact, resolved at restore
    tokenizer: Optional[dict] = None

    @classmethod
    def from_yaml(cls, path: str) -> "ModelConfig":
        from qasr_tpu_torch.utils.yaml_io import safe_load

        with open(path, encoding="utf-8") as f:
            raw = resolve_interpolations(safe_load(f))
        return cls.from_dict(raw["model"] if "model" in raw else raw)

    @classmethod
    def from_dict(cls, m: dict) -> "ModelConfig":
        labels = tuple(m.get("labels", DEFAULT_LABELS))
        enc = EncoderConfig.from_dict(m["encoder"])
        dec_d = dict(m["decoder"])
        # a non-Jasper encoder (the Conformer's) has no blocks, and so no
        # default for the decoder's feat_in
        if not dec_d.get("feat_in") and enc.blocks:
            dec_d["feat_in"] = enc.blocks[-1].filters
        dec_d.setdefault("num_classes", len(labels))
        if not dec_d.get("vocabulary"):
            dec_d["vocabulary"] = labels
        return cls(encoder=enc, decoder=DecoderConfig.from_dict(dec_d),
                   preprocessor=m.get("preprocessor", {}), spec_augment=m.get("spec_augment"),
                   labels=labels, sample_rate=m.get("sample_rate", 16000),
                   tokenizer=m.get("tokenizer"))


def resolve_interpolations(raw):
    """OmegaConf-style ``${a.b.c}`` references (a whole string) replaced by
    the value at that path of ``raw``; a path that does not resolve stays
    a string."""
    pattern = re.compile(r"^\$\{([\w.]+)\}$")

    def lookup(path):
        node = raw
        for k in path.split("."):
            node = node[k]
        return node

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str):
            m = pattern.match(node)
            if m:
                try:
                    return walk(lookup(m.group(1)))
                except (KeyError, TypeError):
                    return node
        return node

    return walk(raw)


def config_to_dict(cfg: ModelConfig) -> dict:
    """A ModelConfig as the YAML-shaped dict ``ModelConfig.from_dict``
    reads (the archives' model_config.yaml)."""
    enc = dataclasses.asdict(cfg.encoder)
    blocks = enc.pop("blocks")
    enc["jasper"] = [{k: (list(v) if isinstance(v, tuple) else v) for k, v in b.items()}
                     for b in blocks]
    enc["feat_in"] = cfg.encoder.feat_in
    dec = dataclasses.asdict(cfg.decoder)
    dec["vocabulary"] = list(dec["vocabulary"])
    out = {"sample_rate": cfg.sample_rate, "labels": list(cfg.labels),
           "preprocessor": dict(cfg.preprocessor), "encoder": enc, "decoder": dec}
    if cfg.tokenizer:
        out["tokenizer"] = dict(cfg.tokenizer)
    return out


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


def quartznet15x5_g4() -> ModelConfig:
    """QuartzNet15x5 with ``groups: 4`` on its 15 repeated blocks B1-B15:
    their pointwise convs grouped, each followed by GroupShuffle; C1, C2
    and C3 stay ungrouped."""
    cfg = quartznet15x5()
    blocks = tuple(dataclasses.replace(b, groups=4) if 1 <= i <= 15 else b
                   for i, b in enumerate(cfg.encoder.blocks))
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, blocks=blocks))


def quartznet15x5_hardtanh() -> ModelConfig:
    """QuartzNet15x5 with NeMo's clipped ReLU (``activation: hardtanh``,
    a clip to [0, 20])."""
    cfg = quartznet15x5()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder,
                                                                activation="hardtanh"))


def jasper_grouped_block() -> ModelConfig:
    """A grouped non-separable residual block at Jasper10x5Dr's widths (C
    768, K 25, 4 groups, 5 repeats) behind an ungrouped K 11 stride-2
    first conv, and a 1x1 block to 1024: the grouped form of Kernel 8 at
    the widths Jasper's dense blocks run (no NeMo card has this block)."""
    blocks = (BlockConfig(filters=768, kernel=(11,), stride=(2,), repeat=1, residual=False),
              BlockConfig(filters=768, kernel=(25,), repeat=5, residual=True, groups=4),
              BlockConfig(filters=1024, kernel=(1,), repeat=1, residual=False))
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
