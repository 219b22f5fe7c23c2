"""Streaming and chunked long-audio inference (port of
qasr_tpu/decode/streaming.py).

Convolutional encoders and local-attention Conformers have a finite
receptive field, so long audio runs in fixed windows with left / right
context and the windows' center regions are stitched
(``StreamingTranscriber``): constant memory, a constant window shape, any
audio length.  With contexts that cover the receptive field (and the
frontend's normalization off, whose statistics are utterance-global) the
stitched outputs equal the full-utterance outputs.  Each window runs the
model's own serving path: the frozen executors on Kernels 1, 2, 7 (and 8
for Jasper) or Kernels 3-6.

``StreamingTransducer`` streams a transducer (``RNNTModel``) the same
way, its greedy decoder's carry kept across chunks.

``CacheAwareConformerStream`` keeps O(1) state instead for a frozen causal
Conformer-CTC (att_context (L, 0), causal_conv): per-layer int8 key /
value and conv-tail caches (``quantize/conformer_freeze.py::
frozen_stream_step``, the cache forms of Kernels 3 and 4), each fed frame
processed once and bit-identical to the offline frozen forward.

Entry points given ``device=None`` run on the CUDA device or raise; the
tests pass ``device="cpu"``.  Nothing here imports jax.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.jasper import EncoderPlan


def _subsampler_span(ccfg) -> Tuple[int, int]:
    """(input-frame span, total stride) of the conv subsampler."""
    sub, st = 0, 1
    n_sub = int(math.log2(ccfg.subsampling_factor)) if ccfg.subsampling else 0
    for _ in range(n_sub):
        if ccfg.subsampling == "vggnet":
            sub += 2 * st + 2 * st + 1 * st  # two k=3 convs + maxpool
        else:
            sub += 2 * st                    # k=3 s=2 valid conv
        st *= 2
    return sub, st


def _finite_context(ccfg) -> Tuple[int, int]:
    left_att, right_att = ccfg.att_context
    if left_att < 0 or right_att < 0:
        raise ValueError("conformer streaming needs a finite receptive field: set "
                         "ConformerConfig.att_context_size")
    return left_att, right_att


def receptive_field_conformer_lr(ccfg) -> Tuple[int, int, int]:
    """(left field, right field, total stride) in mel frames of a Conformer
    with local attention.  With causal convs and att_context (L, 0) the
    right field is the subsampler's few frames: the zero-lookahead
    configuration."""
    left_att, right_att = _finite_context(ccfg)
    sub, st = _subsampler_span(ccfg)
    dw_l, dw_r = ccfg.dw_padding
    return (sub + ccfg.n_layers * (left_att + dw_l) * st,
            sub + ccfg.n_layers * (right_att + dw_r) * st, st)


def receptive_field_conformer(ccfg) -> Tuple[int, int]:
    """(total receptive field, total stride): 1 + subsampler span + per
    layer (attention left + right + depthwise taps - 1) x stride."""
    left_att, right_att = _finite_context(ccfg)
    sub, st = _subsampler_span(ccfg)
    dw_l, dw_r = ccfg.dw_padding
    return 1 + sub + ccfg.n_layers * (left_att + right_att + dw_l + dw_r) * st, st


def receptive_field(plan: EncoderPlan) -> Tuple[int, int]:
    """(receptive field in input frames, total stride) of the conv stack
    (residual 1x1 convs do not extend it)."""
    rf, stride_total = 1, 1
    for bp in plan.blocks:
        for spec in bp.convs:
            rf += (spec.kernel - 1) * spec.dilation * stride_total
            stride_total *= spec.stride
    return rf, stride_total


def _report(lat: List[float], chunk_audio_s: float, audio_s: float, total: float) -> dict:
    """The latency report's shared fields from per-chunk seconds."""
    lat_ms = np.asarray(lat) * 1e3
    return {"chunks": len(lat),
            "chunk_audio_s": chunk_audio_s,
            "first_chunk_latency_ms": float(lat_ms[0]),
            "mean_chunk_latency_ms": float(lat_ms.mean()),
            "p95_chunk_latency_ms": float(np.percentile(lat_ms, 95)),
            "steady_chunk_latency_ms": float(np.median(lat_ms[1:]) if len(lat_ms) > 1
                                             else lat_ms[0]),
            "streaming_rtfx": audio_s / total}


@dataclass
class StreamingTranscriber:
    """Windowed greedy / beam transcription over a CTC model (``ASRModel``:
    QuartzNet, Jasper; ``ConformerCTC`` with local attention), on
    ``device`` (None: the CUDA device).

    chunk_frames / context frames are mel frames (hop 10 ms), rounded up to
    multiples of 16 x the total stride, so window shapes are static and
    output indices align.  A causal Conformer (att_context (L, 0) +
    causal_conv) gets a right context of the subsampler / STFT edge only:
    the added serving latency is one chunk."""

    model: Any
    chunk_frames: int = 1600              # 16 s of frames a step
    context_frames: Optional[int] = None  # default: half the receptive field
    context_left: Optional[int] = None    # default: symmetric (context_frames)
    context_right: Optional[int] = None
    device: Any = None

    def __post_init__(self):
        ccfg = getattr(self.model, "ccfg", None)
        rf_lr = None
        if ccfg is not None:
            self.rf, self.stride = receptive_field_conformer(ccfg)
            rf_lr = receptive_field_conformer_lr(ccfg)
        else:
            self.rf, self.stride = receptive_field(self.model.plan)
        quantum = 16 * self.stride
        fcfg = self.model.frontend.cfg
        # STFT center padding makes ~n_fft / (2 hop) edge frames window-local
        stft_edge = -(-fcfg.n_fft // (2 * fcfg.hop_length)) + 1

        def up(v):
            return -(-v // quantum) * quantum

        # an explicit context_frames keeps its symmetric meaning; the
        # receptive-field defaults are asymmetric otherwise
        explicit_sym = self.context_frames is not None
        self.context_frames = up(self.context_frames if explicit_sym
                                 else self.rf // 2 + stft_edge)
        for side, i in (("context_left", 0), ("context_right", 1)):
            v = getattr(self, side)
            if v is None:
                v = (up(rf_lr[i] + stft_edge) if rf_lr and not explicit_sym
                     else self.context_frames)
            else:
                v = up(v)
            setattr(self, side, v)
        self.chunk_frames = max(up(self.chunk_frames), quantum)
        self.hop = fcfg.hop_length
        self.sample_rate = fcfg.sample_rate
        self.device = as_device(self.device)

    @property
    def lookahead_frames(self) -> int:
        """Mel frames of future audio each chunk's outputs wait for: the
        added latency beyond the chunk itself."""
        return self.context_right

    def _windows(self, n_samples: int):
        """(start, w0, s0, s1, o0) per chunk: the window anchored inside the
        signal (the first keeps the utterance's own start, so the STFT's
        reflect padding and the convs' zero padding match the
        full-utterance computation)."""
        n_frames = int(math.ceil(n_samples / self.hop))
        win = self.context_left + self.chunk_frames + self.context_right
        for start in range(0, n_frames, self.chunk_frames):
            w0 = max(0, start - self.context_left)
            yield (start, w0, w0 * self.hop, min(n_samples, (w0 + win) * self.hop),
                   (start - w0) // self.stride)

    def _chunks(self, audio: np.ndarray):
        """(log_probs, greedy_ids) of each window's valid center region:
        concatenated, the full-utterance outputs."""
        n_frames = int(math.ceil(len(audio) / self.hop))
        full = (self.context_left + self.chunk_frames + self.context_right) * self.hop
        for start, w0, s0, s1, o0 in self._windows(len(audio)):
            seg = audio[s0:s1]
            if len(seg) < full:
                seg = np.concatenate([seg, np.zeros(full - len(seg), audio.dtype)])
            vals, el0 = self._window_forward(seg, s1 - s0)
            valid_in = min(self.chunk_frames, n_frames - start)
            o1 = min(o0 + -(-valid_in // self.stride), el0)
            yield tuple(v[o0:o1] for v in vals)

    def _window_forward(self, seg: np.ndarray, seg_len: int):
        """One padded window -> ((log_probs, greedy ids) as host numpy, the
        valid length), through the model's ``forward`` on the device."""
        out = self.model.forward(seg[None], np.asarray([seg_len], np.int32), device=self.device)
        lp, el = out[0], out[1]
        preds = out[2] if len(out) == 3 else lp.argmax(dim=-1)
        return (lp[0].cpu().numpy(), preds[0].cpu().numpy()), int(el[0])

    def predictions(self, audio: np.ndarray) -> np.ndarray:
        """Greedy ids of one long mono signal, window-stitched."""
        out = [p for _, p in self._chunks(audio)]
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    def transcribe(self, audio: np.ndarray) -> str:
        return ctc_collapse(self.predictions(audio)[None], self.model.blank_id,
                            self.model.vocabulary)[0]

    def transcribe_beam(self, audio: np.ndarray, decoder=None,
                        partials: Optional[List[str]] = None, **beam_kwargs) -> str:
        """Streaming prefix beam search (optionally LM-scored): the native
        ``StreamingBeamDecoder`` carries its beam across windows, so the
        transcript equals offline beam decoding of the whole utterance.
        ``partials`` collects the running best hypothesis after each
        window (a live caption)."""
        from qasr_tpu_torch.decode.beam_search import StreamingBeamDecoder

        dec = decoder or StreamingBeamDecoder(self.model.vocabulary, **beam_kwargs)
        for lp, _ in self._chunks(audio):
            dec.feed(lp)
            if partials is not None:
                best = dec.best(1)
                partials.append(best[0][1] if best else "")
        best = dec.best(1)
        return best[0][1] if best else ""

    def latency_report(self, audio: np.ndarray, beam: bool = False, **beam_kwargs) -> dict:
        """Per-window processing latency (device forward, stitching and the
        optional beam update; the ids' copy to the host synchronizes the
        card before each clock read), first-partial latency and the
        sustained streaming RTFx, the windows processed back to back."""
        dec = None
        if beam:
            from qasr_tpu_torch.decode.beam_search import StreamingBeamDecoder

            dec = StreamingBeamDecoder(self.model.vocabulary, **beam_kwargs)
        lat: List[float] = []
        chunks = self._chunks(audio)
        t_all0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                lp, _ = next(chunks)
            except StopIteration:
                break
            if dec is not None:
                dec.feed(lp)
                dec.best(1)
            lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all0
        if not lat:
            return {"chunks": 0}
        return _report(lat, self.chunk_frames * self.hop / self.sample_rate,
                       len(audio) / float(self.sample_rate), total)


@dataclass
class StreamingTransducer(StreamingTranscriber):
    """Windowed greedy transcription over a transducer (``RNNTModel``: a
    Jasper-family or local-attention Conformer encoder; float, PTQ or
    frozen), on ``device`` (None: the CUDA device).

    The encoder windows are stitched as for CTC and stay on the device;
    the greedy decoder's carry (prediction-network state, last output,
    hypotheses) persists across chunks, so the frames decode as offline
    and the transcript equals offline ``transcribe_greedy`` wherever the
    stitched frames equal the whole utterance's.  The decoder follows the
    model's serving mode: the frozen integer decoder (Kernel 9) after
    ``freeze_decoder``, else the float one."""

    max_symbols_per_step: int = 10

    def _window_forward(self, seg: np.ndarray, seg_len: int):
        enc, el = self.model.encode(seg[None], np.asarray([seg_len], np.int32),
                                    device=self.device)
        return (enc[0],), int(el[0])

    def predictions(self, audio: np.ndarray):
        raise NotImplementedError("transducers have no frame-wise greedy ids; use "
                                  "transcribe / transcribe_batch")

    def transcribe_beam(self, audio: np.ndarray, *a, **k):
        raise NotImplementedError("CTC streaming beam search does not apply to transducers; "
                                  "use RNNTModel.transcribe_beam offline or transcribe() here")

    def _decoder_fns(self):
        """(init(batch) -> carry, frames(enc, lens, carry) -> carry) of the
        model's serving decoder on the streamer's device."""
        m, cfg, n = self.model, self.model.rnnt_cfg, self.max_symbols_per_step
        if m.dec_frozen is not None:
            from qasr_tpu_torch.quantize.rnnt_freeze import (
                frozen_decoder_init,
                greedy_decode_frames_frozen,
            )

            tables = m.decoder_tables(self.device)
            return (lambda b: frozen_decoder_init(tables, cfg, b),
                    lambda enc, lens, carry: greedy_decode_frames_frozen(tables, cfg, enc, lens,
                                                                         carry, n))
        from qasr_tpu_torch.models.rnnt import greedy_decode_frames, greedy_init

        params = m.float_decoder(self.device)
        return (lambda b: greedy_init(params, cfg, b),
                lambda enc, lens, carry: greedy_decode_frames(params, cfg, enc, lens, carry, n))

    def transcribe(self, audio: np.ndarray, partials: Optional[List[str]] = None) -> str:
        """The streamed transcript; ``partials`` collects the running
        hypothesis after each chunk (a live caption)."""
        init, frames = self._decoder_fns()
        carry = init(1)
        for (enc_c,) in self._chunks(audio):
            if len(enc_c):
                carry = frames(enc_c[None], np.asarray([len(enc_c)]), carry)
            if partials is not None:
                partials.append(self.model._text(carry[2][0]))
        return self.model._text(carry[2][0])

    def transcribe_batch(self, audio: np.ndarray, alens: np.ndarray) -> List[str]:
        """S live sessions advanced together: one (S, window) encoder batch
        and one batched greedy loop a tick, rows advancing independently;
        each session's transcript equals its own offline one.  audio (S, L)
        padded signals, alens (S,) valid samples."""
        init, frames = self._decoder_fns()
        audio = np.asarray(audio)
        alens = np.asarray(alens)
        s_n, hop, s = audio.shape[0], self.hop, self.stride
        n_frames = np.ceil(alens / hop).astype(np.int64)
        chunk = self.chunk_frames
        full = (self.context_left + chunk + self.context_right) * hop
        carry = init(s_n)
        # the windows of the longest stream; shorter rows mask out by n_valid
        for start, w0, s0, s1, o0 in self._windows(int(alens.max())):
            seg = audio[:, s0:s1]
            if seg.shape[1] < full:
                seg = np.concatenate([seg, np.zeros((s_n, full - seg.shape[1]), audio.dtype)],
                                     axis=1)
            seg_lens = np.clip(np.minimum(alens, s0 + full) - s0, 0, full).astype(np.int32)
            enc, el = self.model.encode(seg, seg_lens, device=self.device)
            el = el.cpu().numpy()
            valid_in = np.clip(np.minimum(chunk, n_frames - start), 0, None)
            o1 = np.minimum(o0 + -(-valid_in // s), el).astype(np.int64)
            n_valid = np.clip(o1 - o0, 0, None).astype(np.int32)
            t_max = int(n_valid.max())
            if t_max:
                carry = frames(enc[:, o0:o0 + t_max], n_valid, carry)
        return [self.model._text(h) for h in carry[2]]

    def latency_report(self, audio: np.ndarray, beam: bool = False, **beam_kwargs) -> dict:
        """Per-chunk latency with the greedy decode on the clock (the
        encoder window and the emit loop; the card synchronized before each
        clock read), the first chunk's, the sustained streaming RTFx and
        the transcript."""
        if beam or beam_kwargs:
            raise NotImplementedError("transducer streaming is greedy; the beam options are "
                                      "CTC-only")
        init, frames = self._decoder_fns()
        carry = init(1)
        lat: List[float] = []
        chunks = self._chunks(audio)
        t_all0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                (enc_c,) = next(chunks)
            except StopIteration:
                break
            if len(enc_c):
                carry = frames(enc_c[None], np.asarray([len(enc_c)]), carry)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all0
        if not lat:
            return {"chunks": 0}
        rep = _report(lat, self.chunk_frames * self.hop / self.sample_rate,
                      len(audio) / float(self.sample_rate), total)
        rep["text"] = self.model._text(carry[2][0])
        return rep


def _pcm_f32(audio) -> np.ndarray:
    """int16 PCM -> float32 (x * 2^-15, as the frozen serving path reads
    it); float audio as float32."""
    a = np.asarray(audio)
    if a.dtype == np.int16:
        return a.astype(np.float32) * np.float32(2.0 ** -15)
    return a.astype(np.float32, copy=False)


class CacheAwareConformerStream:
    """O(1)-state streaming of a frozen causal Conformer-CTC on ``device``
    (None: the CUDA device): per-layer int8 key / value and conv-tail
    caches (``frozen_stream_step``) in place of a recomputed left-context
    window; each fed frame is processed once, and the emitted encodings
    equal the offline frozen forward's bit for bit.

    Needs att_context_size=(L, 0), causal_conv=True, a frozen model
    (``ConformerCTC.freeze``), a 'striding' subsampler, and the frontend's
    normalization off (its statistics are utterance-global).

    ``feed(audio)`` / ``feed_feats(feats)`` take new samples / mel frames
    and return the new greedy ids; ``flush()`` ends the stream; ``text()``
    collapses everything emitted so far.

    The float32 subsampler runs over windows of one shape whatever the
    slice fed (``SUB_FRAMES`` outputs a window, the tail zero-padded), so
    the library's choice of a convolution algorithm cannot vary with the
    slice size; the stream equals the offline forward where that
    convolution's outputs do not depend on the input's length, which
    ``chip_smoke.py`` checks on the card at 40 ms, 160 ms and 1 s
    slices."""

    SUB_FRAMES = 16   # subsampled frames a subsampler call computes

    def __init__(self, model, device=None):
        ccfg = model.ccfg
        left, right = ccfg.att_context
        if left < 0 or right != 0 or not ccfg.causal_conv:
            raise ValueError("cache-aware streaming needs att_context_size=(L, 0) + "
                             "causal_conv=True")
        if model.mode() != "frozen":
            raise ValueError("freeze the model first (ConformerCTC.freeze)")
        if ccfg.subsampling != "striding":
            raise NotImplementedError("striding subsampler only")
        if model.frontend.cfg.normalize:
            raise ValueError("per-feature normalization is utterance-global; build the "
                             "model with normalize=False")
        self.model = model
        self.ccfg = ccfg
        self.device = as_device(device)
        self.tables = model._tables(self.device)
        n_sub = int(math.log2(ccfg.subsampling_factor))
        self._sub_win = 2 ** (n_sub + 1) - 1     # the subsampler's window
        self._sub_stride = ccfg.subsampling_factor
        fcfg = model.frontend.cfg
        self._hop = fcfg.hop_length
        # a mel frame's support is win_length / 2 each side: a frame is
        # emitted once its real future samples have arrived
        self._w2 = fcfg.win_length // 2
        # lead frames dropped from each re-windowed frontend call, so every
        # kept frame's STFT window (and the preemphasis sample) lies inside
        # the segment
        self._lead = -(-max(fcfg.n_fft // 2, self._w2) // fcfg.hop_length) + 1
        self.reset()

    def reset(self):
        from qasr_tpu_torch.quantize.conformer_freeze import frozen_stream_init

        self._state = frozen_stream_init(self.tables["encoder"], self.ccfg, 1, self.device)
        self._feat_buf = torch.zeros((0, self.ccfg.feat_in), dtype=torch.float32,
                                     device=self.device)
        self._sub_done = 0       # subsampled frames consumed
        self._audio_tail = np.zeros((0,), np.float32)
        self._audio_off = 0      # absolute sample index of _audio_tail[0]
        self._frames_done = 0    # mel frames pushed to _feat_buf
        self._ids: List[int] = []

    # -- feature level ------------------------------------------------------

    @torch.no_grad()
    def feed_feats(self, feats) -> np.ndarray:
        """feats (n, F) new mel frames -> the new greedy ids (m,)."""
        from qasr_tpu_torch.models.conformer import subsample_convs
        from qasr_tpu_torch.quantize.conformer_freeze import frozen_stream_step

        feats = torch.as_tensor(feats).to(self.device, torch.float32)
        self._feat_buf = torch.cat([self._feat_buf, feats], 0)
        f_total = self._sub_done * self._sub_stride + self._feat_buf.shape[0]
        j_avail = max(0, (f_total - self._sub_win) // self._sub_stride + 1)
        n_new = j_avail - self._sub_done
        if n_new <= 0:
            return np.zeros((0,), np.int64)
        enc_t = self.tables["encoder"]
        span = (self.SUB_FRAMES - 1) * self._sub_stride + self._sub_win
        lens = torch.tensor([span], dtype=torch.int32, device=self.device)
        parts = []
        for j0 in range(0, n_new, self.SUB_FRAMES):
            seg = self._feat_buf[j0 * self._sub_stride:j0 * self._sub_stride + span]
            seg = F.pad(seg, (0, 0, 0, span - seg.shape[0]))
            x_sub, _ = subsample_convs(enc_t["subsampler"], self.ccfg, seg[None], lens)
            parts.append(x_sub[:, :min(self.SUB_FRAMES, n_new - j0)])
        enc, self._state = frozen_stream_step(enc_t, self.ccfg, torch.cat(parts, 1),
                                              self._state)
        # keep the overlap the next window needs
        self._feat_buf = self._feat_buf[n_new * self._sub_stride:]
        self._sub_done = j_avail
        ids = self.model.head(self.tables, enc).argmax(dim=-1)[0].cpu().numpy()
        self._ids.extend(int(i) for i in ids)
        return ids

    # -- audio level --------------------------------------------------------

    def _frames(self, n_new: int) -> torch.Tensor:
        """The next ``n_new`` mel frames from the buffered audio, the
        frontend re-run from ``lead`` frames before them (clamped to the
        utterance start, where the offline reflect padding applies)."""
        w0 = max(0, self._frames_done - self._lead)
        seg = self._audio_tail[w0 * self._hop - self._audio_off:]
        with torch.no_grad():
            feats, _ = self.model.frontend(
                torch.from_numpy(np.ascontiguousarray(seg)[None]).to(self.device),
                torch.tensor([len(seg)], dtype=torch.int32, device=self.device), dither=0.0)
        return feats[0, self._frames_done - w0:self._frames_done - w0 + n_new]

    def feed(self, audio) -> np.ndarray:
        """audio (n,) new samples (float32, or int16 PCM) -> the new greedy
        ids.  Every emitted frame's STFT window lies inside real signal, so
        the frames equal the offline frontend's."""
        self._audio_tail = np.concatenate([self._audio_tail, _pcm_f32(audio)])
        total = self._audio_off + len(self._audio_tail)
        # frame f needs real samples up to f * hop + win / 2
        avail = (total - self._w2) // self._hop + 1 if total >= self._w2 else 0
        n_new = avail - self._frames_done
        if n_new <= 0:
            return np.zeros((0,), np.int64)
        new_feats = self._frames(n_new)
        self._frames_done += n_new
        # keep only the audio the next lead window needs
        keep_from = max(0, (self._frames_done - self._lead) * self._hop)
        self._audio_tail = self._audio_tail[keep_from - self._audio_off:]
        self._audio_off = keep_from
        return self.feed_feats(new_feats)

    def flush(self) -> np.ndarray:
        """End of stream: the trailing frames whose STFT windows pass the
        last sample (reflect-padded there, as offline)."""
        n_total = -(-(self._audio_off + len(self._audio_tail)) // self._hop)
        n_new = n_total - self._frames_done
        if n_new <= 0:
            return np.zeros((0,), np.int64)
        new_feats = self._frames(n_new)
        self._frames_done = n_total
        return self.feed_feats(new_feats)

    def text(self) -> str:
        if not self._ids:
            return ""
        return ctc_collapse(np.asarray(self._ids)[None], self.model.blank_id,
                            self.model.vocabulary)[0]

    def latency_report(self, audio, chunk_samples: int) -> dict:
        """``audio`` fed in ``chunk_samples`` slices back to back, each
        feed() timed (frontend, subsampler, stream step, head, greedy; the
        ids' copy to the host synchronizes the card before each clock
        read), then the flush.  The windowed streamer's fields, and
        ``state_frames``, the per-layer cache depth L."""
        self.reset()
        lat: List[float] = []
        t_all0 = time.perf_counter()
        for s0 in range(0, len(audio), chunk_samples):
            t0 = time.perf_counter()
            self.feed(audio[s0:s0 + chunk_samples])
            lat.append(time.perf_counter() - t0)
        self.flush()
        total = time.perf_counter() - t_all0
        if not lat:
            return {"chunks": 0}
        sr = float(self.model.frontend.cfg.sample_rate)
        rep = _report(lat, chunk_samples / sr, len(audio) / sr, total)
        rep["state_frames"] = int(self.ccfg.att_context[0])
        return rep
