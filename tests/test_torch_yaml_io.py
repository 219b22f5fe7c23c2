"""The port's YAML subset reader / writer (qasr_tpu_torch/utils/yaml_io.py)
against PyYAML, which the GPU machine does not have.

(a) ``safe_load`` reads what the JAX package writes into its archives
    (``config_to_dict`` of every preset + ``yaml.safe_dump``, a Conformer
    archive's config with its '_qasr_meta', QuartzNet's labels with ' ' and
    "'") exactly as ``yaml.safe_load`` does, also under safe_dump's other
    styles (flow, narrow width, unicode, indent);
(b) an inline NeMo-style config with the YAML 1.1 hazards: ``1e-05`` a
    string and ``1.0e-05`` a float, yes / no / on / off booleans, ~ / null,
    .inf, ``${...}`` interpolations (then ``resolve_interpolations`` as
    the JAX package's), flow lists, block sequences of mappings, comments,
    anchors and aliases, multi-line quoted and plain scalars; what it does
    not read (tags, block scalars, unclosed collections) raises;
(c) ``safe_dump`` writes text ``yaml.safe_load`` reads back equal, and so
    does ``safe_load``: on those configs and on 300 seeded random trees of
    the scalars above (PyYAML's writer on the same trees too).
Tolerance: equal values and types (floats bit for bit, NaN as NaN).
"""
import dataclasses
import math
import random

import pytest
import yaml

from qasr_tpu.models import config as JC
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig as JQcfg
from qasr_tpu_torch.models import config as PC
from qasr_tpu_torch.utils import yaml_io

STYLES = [{}, {"default_flow_style": None}, {"default_flow_style": True}, {"width": 20},
          {"allow_unicode": True}, {"indent": 4}]

NEMO_TEXT = r"""
# a NeMo-style model config
name: &name QuartzNet15x5
sample_rate: 16000
model:
  sample_rate: ${sample_rate}
  labels: [" ", "a", "b", "'", 'it''s']
  eps: 1e-05         # YAML 1.1: a string
  eps_float: 1.0e-05
  big: 1.0e+20
  inf: .inf
  ninf: -.inf
  flags: {a: yes, b: No, c: on, d: OFF, e: ~, f: null, g: true}
  hex: 0x1f
  octal: 017
  under: 1_000
  sexa: 1:30
  date: 2020-01-02
  empty:
  alias: *name
  train_ds:
    manifest_filepath: ???
    sample_rate: ${model.sample_rate}
    missing: ${model.nothing.here}
  preprocessor:
    _target_: nemo.collections.asr.modules.AudioToMelSpectrogramPreprocessor
    window_size: 0.02
    normalize: "per_feature"
    dither: 0.00001
  encoder:
    jasper:
    - dilation: [1]
      filters: 256
      kernel:
      - 33
      residual: false
      separable: true
    -   filters: 512
        repeat: 5
        kernel: [87]
    - {filters: 1024, kernel: [1], separable: false}
  quoted: "a \"b\" ▁ \
    continued"
  single: 'long line
    folded here'
  multi plain: a plain scalar
    over two lines
"""


def _eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or \
            (a == b and math.copysign(1, a) == math.copysign(1, b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


def _jax_archive_configs():
    cfgs = [JC.config_to_dict(f()) for f in dict.fromkeys(JC.PRESETS.values())]
    conf = JC.config_to_dict(JC.ModelConfig(encoder=JC.EncoderConfig(feat_in=80, blocks=()),
                                            decoder=JC.DecoderConfig(feat_in=256,
                                                                     num_classes=28)))
    conf["_qasr_meta"] = {"family": "conformer_ctc",
                          "conformer_cfg": dataclasses.asdict(JConf(feat_in=80,
                                                                    att_context_size=[8, 0])),
                          "decoder_kind": "lstm",
                          "lstm": {"hidden": 640, "layers": 1, "bidirectional": False},
                          "enc_qcfg": dataclasses.asdict(JQcfg(percentile=99.9)),
                          "tokenizer": "tokenizer.json"}
    cfgs.append(conf)
    bpe = JC.config_to_dict(JC.quartznet5x5())
    bpe["tokenizer"] = {"type": "bpe", "model_path": "tokenizer.json"}
    bpe["labels"] = ["<unk>", "▁", "▁the", "é", "a b", "yes", "1.5", "-", "#", "", " x"]
    cfgs.append(bpe)
    return cfgs


def test_reads_the_jax_archives_configs():
    for cfg in _jax_archive_configs():
        for kw in STYLES:
            text = yaml.safe_dump(cfg, **kw)
            want = yaml.safe_load(text)
            assert _eq(yaml_io.safe_load(text), want), kw
    text = yaml.safe_dump(JC.config_to_dict(JC.quartznet15x5()))
    assert "- ' '" in text and "- ''''" in text
    assert PC.ModelConfig.from_dict(yaml_io.safe_load(text)) == PC.quartznet15x5()


def test_reads_nemo_hazards():
    want = yaml.safe_load(NEMO_TEXT)
    got = yaml_io.safe_load(NEMO_TEXT)
    assert _eq(got, want)
    m = got["model"]
    assert m["eps"] == "1e-05" and m["eps_float"] == 1e-05 and m["inf"] == math.inf
    assert m["flags"] == {"a": True, "b": False, "c": True, "d": False, "e": None, "f": None,
                          "g": True}
    assert m["labels"] == [" ", "a", "b", "'", "it's"] and m["empty"] is None
    assert _eq(PC.resolve_interpolations(got), JC.resolve_interpolations(want))
    assert PC.resolve_interpolations(got)["model"]["train_ds"]["sample_rate"] == 16000


@pytest.mark.parametrize("text", ["a: [1, 2", "a: 'open", "- a\nb: 1", "a: b: c",
                                  "!!python/tuple [1]", "a: !!float '1'", "a: |\n  b\n"])
def test_refuses_what_it_cannot_read(text):
    with pytest.raises(ValueError):
        yaml_io.safe_load(text)


def _tree(rnd, depth=0):
    atoms = ["", " ", "'", '"', "yes", "No", "~", "null", "1e-05", ".inf", "0x1f", "017",
             "12:30", "a: b", "a #b", "#x", "- x", "x:", "${model.x}", "[1]", "{a}", "▁", "it's",
             "tab\tx", "new\nline", " lead", "trail ", "---", "2020-01-02", "=", "<<", "&a", "*b",
             "!x", "|", ">", "%", "@", "`", "w " * 50, "\x01", "é", 0, -7, 10 ** 15, 0.0, -0.0,
             1e-05, 3.14, 1e20, -2.5e-300, math.inf, -math.inf, math.nan, True, False, None]
    k = rnd.random()
    if depth > 3 or k < 0.4:
        return rnd.choice(atoms)
    if k < 0.7:
        return [_tree(rnd, depth + 1) for _ in range(rnd.randint(0, 4))]
    keys = ["a", "key", "x y", "1", "true", "it's", "▁", 7, None, False,
            "k" + str(rnd.randint(0, 9))]
    return {rnd.choice(keys): _tree(rnd, depth + 1) for _ in range(rnd.randint(0, 4))}


def test_round_trips_through_pyyaml():
    rnd = random.Random(0)
    trees = _jax_archive_configs() + [yaml.safe_load(NEMO_TEXT)] + \
        [_tree(rnd) for _ in range(300)]
    for t in trees:
        text = yaml_io.safe_dump(t)
        assert _eq(yaml.safe_load(text), t), text
        assert _eq(yaml_io.safe_load(text), t), text
        for kw in STYLES[:4]:
            other = yaml.safe_dump(t, **kw)
            assert _eq(yaml_io.safe_load(other), yaml.safe_load(other)), (kw, other)
    assert yaml_io.safe_dump(1e-05) == "1.0e-05\n" and yaml_io.safe_load("1.0e-05") == 1e-05
