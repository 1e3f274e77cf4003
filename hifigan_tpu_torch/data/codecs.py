"""(A copy of ``hifigan_tpu/data/codecs.py``.) Real MP3 / Vorbis codec round-trips via ctypes bindings to the system
codec libraries (libmp3lame + libmpg123, libvorbisenc + libvorbisfile +
libogg).

The reference's CodecAugmentor shells into torchaudio's sox backend
(reference speech_distillation/augmentation/augmentation_methods.py:72-95:
``apply_codec(format='mp3', compression=-9)`` / ``('vorbis',
compression=-1)``). This module needs neither sox nor torchaudio-with-sox:
it binds the codec LIBRARIES directly, where they load:

- MP3: lame VBR encode (quality 9 == sox ``-C -9``) -> mpg123 streaming
  decode, with the encoder+decoder delay (lame_get_encoder_delay + the
  MDCT/filterbank priming of the decoder, 529 samples) trimmed so the
  round trip is time-aligned like sox's output.
- Vorbis: vorbisenc VBR (base quality -0.1 == sox ``-C -1``; sox scales the
  compression level by 0.1) through a real Ogg stream, decoded with
  vorbisfile over in-memory callbacks. Vorbis streams are sample-exact
  (granulepos trims the priming), so no manual alignment is needed.

Structures passed to the libs are either ABI-stable (ogg_packet/ogg_page,
declared exactly) or opaque-oversized blobs (vorbis_info, dsp/block state,
OggVorbis_File) the libraries themselves initialise — the standard
header-less ctypes technique. Availability is probed once; callers fall
back to the MDCT stand-in when a library is missing
(data/augmentation.py CodecAugmentor).
"""

from __future__ import annotations

import ctypes as C
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _libs():
    out = {}
    try:
        out["lame"] = C.CDLL("libmp3lame.so.0")
    except OSError:
        out["lame"] = None
    try:
        out["mpg123"] = C.CDLL("libmpg123.so.0")
    except OSError:
        out["mpg123"] = None
    try:
        out["ogg"] = C.CDLL("libogg.so.0")
        out["vorbis"] = C.CDLL("libvorbis.so.0")
        out["vorbisenc"] = C.CDLL("libvorbisenc.so.2")
        out["vorbisfile"] = C.CDLL("libvorbisfile.so.3")
    except OSError:
        out["vorbisenc"] = None
    return out


def mp3_available() -> bool:
    ls = _libs()
    return ls.get("lame") is not None and ls.get("mpg123") is not None


def vorbis_available() -> bool:
    return _libs().get("vorbisenc") is not None


# ---------------------------------------------------------------------------
# MP3: lame encode -> mpg123 decode
# ---------------------------------------------------------------------------


def mp3_roundtrip(wav: np.ndarray, sr: int, vbr_quality: int = 9) -> np.ndarray:
    """Mono float32 [-1,1] -> lame VBR mp3 -> mpg123 -> float32, same length.

    ``vbr_quality``: lame VBR quality 0 (best) .. 9 (worst); the reference's
    ``compression=-9`` is sox's mp3 VBR quality 9."""
    ls = _libs()
    lame, mpg = ls["lame"], ls["mpg123"]
    x = np.ascontiguousarray(np.clip(wav, -1.0, 1.0), np.float32)
    n = len(x)

    lame.lame_init.restype = C.c_void_p
    gfp = C.c_void_p(lame.lame_init())
    try:
        lame.lame_set_in_samplerate(gfp, C.c_int(sr))
        lame.lame_set_out_samplerate(gfp, C.c_int(sr))
        lame.lame_set_num_channels(gfp, 1)
        lame.lame_set_mode(gfp, 3)  # MONO
        lame.lame_set_VBR(gfp, 4)  # vbr_default (VBR MTRH)
        lame.lame_set_VBR_q(gfp, C.c_int(int(vbr_quality)))
        if lame.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")

        bufsize = int(1.25 * n + 7200) + 7200
        mp3buf = (C.c_ubyte * bufsize)()
        lame.lame_encode_buffer_ieee_float.argtypes = [
            C.c_void_p, C.c_void_p, C.c_void_p, C.c_int, C.c_void_p, C.c_int
        ]
        m = lame.lame_encode_buffer_ieee_float(
            gfp, x.ctypes.data_as(C.c_void_p), x.ctypes.data_as(C.c_void_p),
            n, C.cast(mp3buf, C.c_void_p), bufsize,
        )
        if m < 0:
            raise RuntimeError(f"lame encode failed: {m}")
        m2 = lame.lame_encode_flush(
            gfp, C.cast(C.byref(mp3buf, m), C.c_void_p), bufsize - m
        )
        mp3_bytes = bytes(bytearray(mp3buf)[: m + max(m2, 0)])
        # valid after encoding: the analysis filterbank priming the decoder
        # cannot know about (the Xing/LAME info tag carries it, but the
        # feed-API decode below does not parse side data)
        enc_delay = int(lame.lame_get_encoder_delay(gfp))
        if enc_delay <= 0:
            enc_delay = 576  # lame's fixed MDCT delay
    finally:
        lame.lame_close(gfp)

    # ---- decode (mpg123 feed API, float32 output) ----
    MPG123_OK, MPG123_NEW_FORMAT, MPG123_NEED_MORE, MPG123_DONE = 0, -11, -10, -12
    MPG123_ENC_FLOAT_32 = 0x200
    mpg.mpg123_init()
    mpg.mpg123_new.restype = C.c_void_p
    err = C.c_int(0)
    mh = C.c_void_p(mpg.mpg123_new(None, C.byref(err)))
    if not mh:
        raise RuntimeError("mpg123_new failed")
    try:
        mpg.mpg123_open_feed(mh)
        mpg.mpg123_format_none(mh)
        mpg.mpg123_format(mh, C.c_long(sr), C.c_int(3), C.c_int(MPG123_ENC_FLOAT_32))
        mpg.mpg123_feed.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
        mpg.mpg123_feed(mh, mp3_bytes, len(mp3_bytes))
        out = bytearray()
        chunk = (C.c_ubyte * 65536)()
        done = C.c_size_t(0)
        while True:
            rc = mpg.mpg123_read(mh, C.cast(chunk, C.c_void_p),
                                 C.c_size_t(65536), C.byref(done))
            if done.value:
                out += bytes(bytearray(chunk)[: done.value])
            if rc in (MPG123_NEED_MORE, MPG123_DONE):
                break
            if rc not in (MPG123_OK, MPG123_NEW_FORMAT):
                break
        y = np.frombuffer(bytes(out), np.float32)
        rate = C.c_long(0)
        ch = C.c_int(0)
        enc = C.c_int(0)
        mpg.mpg123_getformat(mh, C.byref(rate), C.byref(ch), C.byref(enc))
        if ch.value > 1:
            y = y.reshape(-1, ch.value)[:, 0].copy()
    finally:
        mpg.mpg123_delete(mh)

    # time-align: encoder delay + the decoder's 529-sample filterbank priming
    # + one extra 576-sample granule the mpg123 feed path does not flush
    # (measured constant across 8k/16k/22.05k and signal types; the gapless
    # info in the LAME tag that file-based decoders use to trim this is not
    # parsed by the feed API)
    off = enc_delay + 529 + 576
    y = y[off : off + n]
    if len(y) < n:
        y = np.pad(y, (0, n - len(y)))
    return np.asarray(y, np.float32)


# ---------------------------------------------------------------------------
# Vorbis: vorbisenc + ogg stream encode -> vorbisfile decode
# ---------------------------------------------------------------------------


class _OggPacket(C.Structure):
    _fields_ = [
        ("packet", C.POINTER(C.c_ubyte)),
        ("bytes", C.c_long),
        ("b_o_s", C.c_long),
        ("e_o_s", C.c_long),
        ("granulepos", C.c_int64),
        ("packetno", C.c_int64),
    ]


class _OggPage(C.Structure):
    _fields_ = [
        ("header", C.POINTER(C.c_ubyte)),
        ("header_len", C.c_long),
        ("body", C.POINTER(C.c_ubyte)),
        ("body_len", C.c_long),
    ]


def _blob(size=8192):
    return (C.c_ubyte * size)()


def vorbis_roundtrip(wav: np.ndarray, sr: int, quality: float = -0.1) -> np.ndarray:
    """Mono float32 -> Ogg Vorbis VBR -> float32, same length. ``quality``
    is vorbisenc base_quality in [-0.1, 1.0]; the reference's
    ``compression=-1`` is sox's vorbis level -1 == base quality -0.1."""
    ls = _libs()
    ogg, vbs, enc = ls["ogg"], ls["vorbis"], ls["vorbisenc"]
    x = np.ascontiguousarray(np.clip(wav, -1.0, 1.0), np.float32)
    n = len(x)

    vi, vc, vd, vb, os_ = _blob(), _blob(), _blob(), _blob(), _blob()
    vbs.vorbis_info_init(vi)
    try:
        rc = enc.vorbis_encode_init_vbr(
            vi, C.c_long(1), C.c_long(sr), C.c_float(float(quality))
        )
        if rc != 0:
            raise RuntimeError(f"vorbis_encode_init_vbr failed: {rc}")
        vbs.vorbis_comment_init(vc)
        vbs.vorbis_analysis_init(vd, vi)
        vbs.vorbis_block_init(vd, vb)
        ogg.ogg_stream_init(os_, C.c_int(1))

        data = bytearray()
        pg = _OggPage()

        def flush_pages(force):
            fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
            while fn(os_, C.byref(pg)) != 0:
                data.extend(C.string_at(pg.header, pg.header_len))
                data.extend(C.string_at(pg.body, pg.body_len))

        hmain, hcomm, hcode = _OggPacket(), _OggPacket(), _OggPacket()
        vbs.vorbis_analysis_headerout(vd, vc, C.byref(hmain), C.byref(hcomm),
                                      C.byref(hcode))
        for hp in (hmain, hcomm, hcode):
            ogg.ogg_stream_packetin(os_, C.byref(hp))
        flush_pages(True)

        op = _OggPacket()

        def drain():
            while vbs.vorbis_analysis_blockout(vd, vb) == 1:
                vbs.vorbis_analysis(vb, None)
                vbs.vorbis_bitrate_addblock(vb)
                while vbs.vorbis_bitrate_flushpacket(vd, C.byref(op)) == 1:
                    ogg.ogg_stream_packetin(os_, C.byref(op))
                    flush_pages(False)

        vbs.vorbis_analysis_buffer.restype = C.POINTER(C.POINTER(C.c_float))
        pos = 0
        chunk = 4096
        while pos < n:
            m = min(chunk, n - pos)
            buf = vbs.vorbis_analysis_buffer(vd, C.c_int(m))
            C.memmove(buf[0], x[pos : pos + m].ctypes.data, m * 4)
            vbs.vorbis_analysis_wrote(vd, C.c_int(m))
            drain()
            pos += m
        vbs.vorbis_analysis_wrote(vd, 0)  # EOS
        drain()
        flush_pages(True)
        ogg_bytes = bytes(data)
    finally:
        # teardown in reverse init order (blobs leak nothing the libs own)
        ogg.ogg_stream_clear(os_)
        vbs.vorbis_block_clear(vb)
        vbs.vorbis_dsp_clear(vd)
        vbs.vorbis_comment_clear(vc)
        vbs.vorbis_info_clear(vi)

    # ---- decode via the raw synthesis API (pointer-only calls: libogg
    # page/packet demux + libvorbis synthesis; vorbisfile's ov_callbacks
    # struct-by-value ABI is avoided deliberately) ----
    oy, dos = _blob(), _blob()
    dvi, dvc, dvd, dvb = _blob(), _blob(), _blob(), _blob()
    ogg.ogg_sync_init(oy)
    ogg.ogg_sync_buffer.restype = C.c_void_p
    vbs.vorbis_info_init(dvi)
    vbs.vorbis_comment_init(dvc)
    outs = []
    stream_ready = False
    synth_ready = False
    try:
        buf = ogg.ogg_sync_buffer(oy, C.c_long(len(ogg_bytes)))
        C.memmove(buf, ogg_bytes, len(ogg_bytes))
        ogg.ogg_sync_wrote(oy, C.c_long(len(ogg_bytes)))

        pg2 = _OggPage()
        op2 = _OggPacket()
        n_hdr = 0
        vbs.vorbis_synthesis_pcmout.argtypes = [
            C.c_void_p, C.POINTER(C.POINTER(C.POINTER(C.c_float)))
        ]
        pcm = C.POINTER(C.POINTER(C.c_float))()
        while ogg.ogg_sync_pageout(oy, C.byref(pg2)) == 1:
            if not stream_ready:
                serial = ogg.ogg_page_serialno(C.byref(pg2))
                ogg.ogg_stream_init(dos, C.c_int(serial))
                stream_ready = True
            ogg.ogg_stream_pagein(dos, C.byref(pg2))
            while ogg.ogg_stream_packetout(dos, C.byref(op2)) == 1:
                if n_hdr < 3:
                    rc = vbs.vorbis_synthesis_headerin(
                        dvi, dvc, C.byref(op2)
                    )
                    if rc != 0:
                        raise RuntimeError(f"vorbis header parse: {rc}")
                    n_hdr += 1
                    if n_hdr == 3:
                        vbs.vorbis_synthesis_init(dvd, dvi)
                        vbs.vorbis_block_init(dvd, dvb)
                        synth_ready = True
                    continue
                if vbs.vorbis_synthesis(dvb, C.byref(op2)) == 0:
                    vbs.vorbis_synthesis_blockin(dvd, dvb)
                while True:
                    got = vbs.vorbis_synthesis_pcmout(dvd, C.byref(pcm))
                    if got <= 0:
                        break
                    outs.append(
                        np.ctypeslib.as_array(pcm[0], shape=(got,)).copy()
                    )
                    vbs.vorbis_synthesis_read(dvd, C.c_int(got))
        y = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    finally:
        if stream_ready:
            ogg.ogg_stream_clear(dos)
        if synth_ready:
            vbs.vorbis_block_clear(dvb)
            vbs.vorbis_dsp_clear(dvd)
        vbs.vorbis_comment_clear(dvc)
        vbs.vorbis_info_clear(dvi)
        ogg.ogg_sync_clear(oy)

    y = y[:n]
    if len(y) < n:
        y = np.pad(y, (0, n - len(y)))
    return np.asarray(y, np.float32)


# ---------------------------------------------------------------------------
# GSM 06.10 via the canonical libgsm (bit-exact ETSI fixed-point)
# ---------------------------------------------------------------------------


def libgsm_available() -> bool:
    try:
        C.CDLL("libgsm.so.1")
        return True
    except OSError:
        return False


def gsm_roundtrip_libgsm_8k(wav: np.ndarray) -> np.ndarray:
    """8 kHz float PCM through the CANONICAL libgsm encode+decode (160-sample
    frames, 33-byte packets). Preferred over the from-spec float adaptation
    in native/gsm0610.cpp when the system library exists — libgsm is the
    ETSI reference fixed-point code (what sox/torchaudio use underneath,
    reference augmentation_methods.py:72-95)."""
    lg = C.CDLL("libgsm.so.1")
    lg.gsm_create.restype = C.c_void_p
    x = np.ascontiguousarray(np.clip(wav, -1.0, 1.0), np.float32)
    n = len(x)
    n_pad = (-n) % 160
    pcm = (np.pad(x, (0, n_pad)) * 32767.0).astype(np.int16)
    out = np.zeros_like(pcm)
    h_enc = C.c_void_p(lg.gsm_create())
    h_dec = C.c_void_p(lg.gsm_create())
    try:
        frame = (C.c_ubyte * 33)()
        for f in range(len(pcm) // 160):
            seg = np.ascontiguousarray(pcm[f * 160 : (f + 1) * 160])
            lg.gsm_encode(h_enc, seg.ctypes.data_as(C.c_void_p), frame)
            dec = np.zeros(160, np.int16)
            lg.gsm_decode(h_dec, frame, dec.ctypes.data_as(C.c_void_p))
            out[f * 160 : (f + 1) * 160] = dec
    finally:
        lg.gsm_destroy(h_enc)
        lg.gsm_destroy(h_dec)
    return (out[:n].astype(np.float32) / 32768.0)
