"""VAD in the port against the JAX package: ``decode/vad.py`` (the port's
copy: smoothing, segment tables, diarization manifests, the directory
driver) equal to the JAX functions, ``AudioToSpeechLabelDataset``'s
windows and batches equal, and ``cli.vad_infer --device cpu`` (random
MatchboxNet-3x1x64 weights from seed 0, or a ``.qasr``) writing frame files
within 1e-4 of the JAX CLI's on the same seeded wavs; ``cli.vad_post``
turns them into the same tables as the JAX CLI.
"""
import json
import os

import numpy as np
import pytest

from qasr_tpu.cli import vad_infer as jax_vad_infer
from qasr_tpu.cli import vad_post as jax_vad_post
from qasr_tpu.data.audio_to_label import AudioToSpeechLabelDataset as JaxDataset
from qasr_tpu.decode import vad as JV
from qasr_tpu_torch.cli import vad_infer, vad_post
from qasr_tpu_torch.data.audio import write_wav
from qasr_tpu_torch.data.audio_to_label import AudioToSpeechLabelDataset
from qasr_tpu_torch.decode import vad as PV


def frames(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return np.clip(np.cumsum(rng.normal(size=n) * 0.1) * 0.3 + 0.5, 0, 1)


@pytest.mark.parametrize("method", ["mean", "median"])
@pytest.mark.parametrize("overlap,seg_len,shift", [(0.875, 0.63, 0.01), (0.5, 0.4, 0.02)])
def test_smoothing_and_segments_match_jax(method, overlap, seg_len, shift):
    f = frames(int(overlap * 10))
    kw = dict(method=method, overlap=overlap, seg_len=seg_len, shift_len=shift)
    np.testing.assert_array_equal(PV.smooth_overlap(f, **kw), JV.smooth_overlap(f, **kw))
    for thr in (0.3, 0.5, 0.8):
        assert PV.frames_to_segments(f, threshold=thr, shift_len=shift) == \
            JV.frames_to_segments(f, threshold=thr, shift_len=shift)
    with pytest.raises(ValueError, match="jump_on_frame"):
        PV.smooth_overlap(f, overlap=0.999)


def test_tables_manifests_and_driver_match_jax(tmp_path):
    segs = PV.frames_to_segments(frames(3), threshold=0.5)
    out = {}
    for name, mod in (("port", PV), ("jax", JV)):
        d = tmp_path / name
        (d / "frames").mkdir(parents=True)
        for i in range(2):
            np.savetxt(d / "frames" / f"utt{i}.frame", frames(i), fmt="%.4f")
        mod.write_segment_table(segs, str(d / "t.txt"))
        ov, tb = mod.process_frame_dir(str(d / "frames"), overlap_out_dir=str(d / "ov"),
                                       table_out_dir=str(d / "tables"), threshold=0.6)
        mod.segments_to_manifest(tb, "/audio", str(d / "diar.json"))
        out[name] = {p: (d / p).read_text() for p in
                     ["t.txt", "diar.json", "ov/utt0.median", "ov/utt1.median",
                      "tables/utt0.txt", "tables/utt1.txt"]}
    assert out["port"] == out["jax"]
    table = str(tmp_path / "port" / "t.txt")
    assert PV.read_segment_table(table) == JV.read_segment_table(table)
    assert len(PV.read_segment_table(table)) == len(segs) > 3


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two seeded wavs (0.9 s and 0.7 s: 27 and 7 windows of 0.63 s at
    0.01 s) and their label manifest (dummy labels, as VAD inference
    manifests have)."""
    root = tmp_path_factory.mktemp("vad")
    rng = np.random.default_rng(17)
    rows = []
    for i, seconds in enumerate((0.9, 0.7)):
        n = int(16000 * seconds)
        x = rng.normal(size=n) * 0.05
        x[n // 3: 2 * n // 3] *= 6.0            # a louder, speech-like stretch
        path = str(root / f"utt{i}.wav")
        write_wav(path, x.astype(np.float32))
        rows.append({"audio_filepath": path, "duration": seconds, "label": "infer"})
    manifest = root / "manifest.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return root, str(manifest)


def test_vad_windows_and_batches_match_jax(wavs):
    _, manifest = wavs
    kw = dict(min_duration=None, time_length=0.63, shift_length=0.01,
              keep_unknown_labels=True)
    ds = AudioToSpeechLabelDataset(manifest, ["background", "speech"], **kw)
    jd = JaxDataset(manifest, ["background", "speech"], **kw)
    assert ds.items == jd.items and len(ds) == 2
    for i in range(2):
        got, want = list(ds.vad_windows(i)), list(jd.vad_windows(i))
        assert len(got) == len(want) > 5
        for (a, la), (b, lb) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert la == lb == -1
    for (a, la, ya), (b, lb, yb) in zip(ds.batches(2), jd.batches(2)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ya, yb)
    # without keep_unknown_labels the dummy rows go
    assert len(AudioToSpeechLabelDataset(manifest, ["background", "speech"])) == 0


def read_frames(path):
    return np.loadtxt(path, ndmin=2)


def test_vad_infer_cpu_matches_jax_cli(wavs, tmp_path, monkeypatch):
    monkeypatch.setenv("QASR_COMPILE_CACHE", "0")   # the JAX CLI's on-disk cache: off
    root, manifest = wavs
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    got = vad_infer.main(["--dataset", manifest, "--out_dir", port_out, "--device", "cpu"])
    want = jax_vad_infer.main(["--dataset", manifest, "--out_dir", jax_out])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        ["utt0.frame", "utt1.frame"]
    for g, w in zip(got, want):
        a, b = read_frames(g), read_frames(w)
        assert a.shape == b.shape and a.shape[1] == 2 and a.shape[0] > 5
        np.testing.assert_allclose(a, b, atol=1e-4 + 1e-9)
        np.testing.assert_allclose(a.sum(1), 1.0, atol=2e-4)
    # post-processing of the port's frames: the same tables either CLI writes
    for mod, out in ((vad_post, tmp_path / "pp"), (jax_vad_post, tmp_path / "jp")):
        mod.main(["--gen_overlap_seq", "--gen_seg_table", "--frame_folder", port_out,
                  "--overlap_out_dir", str(out / "ov"), "--table_out_dir", str(out / "tb"),
                  "--to_manifest", "--audio_directory", str(root),
                  "--manifest_file", str(out / "diar.json")])
    for p in ("tb/utt0.txt", "tb/utt1.txt", "diar.json"):
        assert (tmp_path / "pp" / p).read_text() == (tmp_path / "jp" / p).read_text()


def test_vad_infer_checkpoint_labels(wavs, tmp_path):
    """A .qasr checkpoint serves; its class order is checked against
    --labels."""
    from qasr_tpu_torch.models.classification import EncDecClassificationModel
    from qasr_tpu_torch.models.config import matchboxnet3x1x64

    _, manifest = wavs
    path = str(tmp_path / "vad.qasr")
    EncDecClassificationModel.from_config(matchboxnet3x1x64(), num_classes=2, seed=3,
                                          labels=("background", "speech")).save_to(path)
    out = vad_infer.main(["--dataset", manifest, "--vad_model", path, "--device", "cpu",
                          "--out_dir", str(tmp_path / "f")])
    assert read_frames(out[0]).shape[1] == 2
    with pytest.raises(ValueError, match="training order"):
        vad_infer.main(["--dataset", manifest, "--vad_model", path, "--device", "cpu",
                        "--labels", "speech,background", "--out_dir", str(tmp_path / "g")])
