"""WebP frames without Pillow or OpenCV: the RIFF container, the VP8 lossy
codec (RFC 6386) with libwebp's fancy chroma upsampling and YUV to RGB
conversion, the VP8L lossless codec (RFC 9649) and the alpha plane, each
reproduced bit for bit from libwebp 1.6.0, which both of the JAX package's
readers link (Pillow 12.1.0 through its ``WebPAnimDecoder``, OpenCV
through its own build).

The loops that are slow in Python (the boolean decoder, tokens,
reconstruction and loop filter of VP8; upsampling and YUV to RGB; VP8L's
prefix codes, LZ77, colour cache and transforms; the alpha unfiltering)
run in the C++ helper ``csrc/webp_decode.cpp``; each has a reference here,
named ``*_numpy``, that stands in for it when g++ is missing (a
``RuntimeWarning``, once). The VP8 reference is a plain Python loop over
the tokens: fine on small files, slow on video frames.

What a file gives: Pillow opens every WebP as "RGBA" when libwebp's
``WebPGetFeatures`` reports alpha and as "RGB" otherwise: a ``VP8X`` file
reports its alpha flag, except that a still ``VP8L`` image reports its own
``alpha_is_used`` bit instead, and an ``ALPH`` chunk beside a still image
adds alpha (but without the flag libwebp's demuxer drops the chunk, so
that the alpha is 255); a simple ``VP8L`` file reports its bit, a simple
``VP8 `` file none. The pixels are the first frame composed onto a canvas
of the ``VP8X`` size (zeros outside the frame: the ``ANIM`` background
colour is ignored), not premultiplied. ``convert("RGB")`` and OpenCV's
``imread`` drop the alpha, so both readers give the same bits. ``ICCP``,
``EXIF`` (an orientation too) and ``XMP `` chunks are read past and not
applied, as neither reader applies them. A file that libwebp refuses
raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

# ---------------------------------------------------------------------------
# The container (libwebp src/demux/demux.c, src/dec/webp_dec.c)
# ---------------------------------------------------------------------------

ALPHA_FLAG, ANIMATION_FLAG, VALID_FLAGS = 0x10, 0x02, 0x3E
VP8L_SIGNATURE = 0x2F


class Frame:
    """One frame of a WebP file: where it lies on the canvas, its size,
    its image chunk (``vp8`` or ``vp8l`` payload) and its ``ALPH``
    payload, if any."""

    def __init__(self, x: int, y: int, vp8: bytes | None,
                 vp8l: bytes | None, alph: bytes | None, name: str):
        self.x, self.y, self.vp8, self.vp8l, self.alph = x, y, vp8, vp8l, \
            alph
        if vp8 is not None:
            self.width, self.height = vp8_size(vp8, name)
        else:
            self.width, self.height, self.alpha_is_used = vp8l_size(vp8l,
                                                                    name)


class WebPFile:
    """A parsed WebP file: ``canvas`` (width, height), ``frame`` (the
    first), ``frames`` (their count), ``has_alpha`` (what
    ``WebPGetFeatures`` reports, which decides Pillow's mode), and
    ``animated``."""

    def __init__(self, data: bytes, name: str):
        self.name = name
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise ValueError(f"{name}: not a WebP file")
        riff = struct.unpack("<I", data[4:8])[0]
        if riff < 12 or riff + 8 > len(data):
            self.fail("a truncated WebP file (the RIFF size runs past its "
                      "end)")
        chunks = self._chunks(data, 12, riff + 8)
        if not chunks:
            self.fail("a WebP file without chunks")
        first = chunks[0][0]
        self.animated, self.frames = False, 1
        if first in (b"VP8 ", b"VP8L"):
            self.frame = self._image(chunks, 0)[0]
            self.canvas = (self.frame.width, self.frame.height)
            self.has_alpha = first == b"VP8L" and self.frame.alpha_is_used
            return
        if first != b"VP8X":
            self.fail(f"a WebP file whose first chunk is {first!r}, not "
                      "VP8, VP8L or VP8X")
        vp8x = chunks[0][1]
        if len(vp8x) < 10:
            self.fail("a WebP file with a short VP8X chunk")
        flags = vp8x[0]
        if flags & ~VALID_FLAGS:
            self.fail(f"a WebP file with invalid VP8X flags {flags:#x}")
        self.canvas = (1 + int.from_bytes(vp8x[4:7], "little"),
                       1 + int.from_bytes(vp8x[7:10], "little"))
        self.animated = bool(flags & ANIMATION_FLAG)
        frames, anim = [], False
        i = 1
        while i < len(chunks):
            kind, body, _ = chunks[i]
            if kind in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim or self.animated or frames:
                    self.fail("a WebP file with an image outside ANMF in "
                              "an animation, or two images")
                frame, i = self._image(chunks, i)
                frames.append(frame)
                continue
            if kind == b"ANIM":
                if len(body) < 6:
                    self.fail("a WebP file with a short ANIM chunk")
                anim = True
            elif kind == b"ANMF":
                if not anim:
                    self.fail("a WebP file with ANMF before ANIM")
                if len(body) < 16:
                    self.fail("a WebP file with a short ANMF chunk")
                x = 2 * int.from_bytes(body[0:3], "little")
                y = 2 * int.from_bytes(body[3:6], "little")
                sub = self._chunks(body, 16, len(body))
                if self.animated:
                    frame = self._image(sub, 0, x, y)[0]
                    frames.append(frame)
            i += 1
        if not frames:
            self.fail("a WebP file without an image")
        W, H = self.canvas
        for f in frames:
            inside = (f.x + f.width <= W and f.y + f.height <= H)
            if not inside or (not self.animated and (f.width, f.height)
                              != self.canvas):
                self.fail(f"a WebP frame of {f.width}x{f.height} at "
                          f"({f.x}, {f.y}) outside its {W}x{H} canvas")
        self.frame, self.frames = frames[0], len(frames)
        if self.animated:
            self.has_alpha = bool(flags & ALPHA_FLAG)
        else:
            f = self.frame
            self.has_alpha = ((f.alpha_is_used if f.vp8l is not None
                               else bool(flags & ALPHA_FLAG))
                              or f.alph is not None)
            if not flags & ALPHA_FLAG:
                f.alph = None          # the demuxer drops it: alpha 255

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def _chunks(self, data: bytes, pos: int, end: int) -> list:
        """[(fourcc, payload, payload and its pad byte)] of the chunks in
        data[pos:end], each padded to an even size."""
        out = []
        while pos < end:
            if pos + 8 > end:
                self.fail("a truncated WebP file (a chunk header runs past "
                          "its end)")
            kind = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if pos + 8 + size + (size & 1) > end:
                self.fail(f"a truncated WebP file (its {kind!r} chunk runs "
                          "past its end)")
            out.append((kind, data[pos + 8:pos + 8 + size],
                        data[pos + 8:pos + 8 + size + (size & 1)]))
            pos += 8 + size + (size & 1)
        return out

    def _image(self, chunks: list, i: int, x: int = 0, y: int = 0):
        """The frame of the ``ALPH``? + ``VP8 ``/``VP8L`` chunks at
        chunks[i:], and the index past them."""
        alph = None
        if i < len(chunks) and chunks[i][0] == b"ALPH":
            alph = chunks[i][1]
            i += 1
        if i >= len(chunks) or chunks[i][0] not in (b"VP8 ", b"VP8L"):
            self.fail("a WebP file whose frame has no VP8 or VP8L chunk")
        # the image's decoder reads on to the chunk's end, its pad included
        kind, _, body = chunks[i]
        if kind == b"VP8L" and alph is not None:
            self.fail("a WebP file with an ALPH chunk before VP8L")
        frame = Frame(x, y, body if kind == b"VP8 " else None,
                      body if kind == b"VP8L" else None, alph, self.name)
        return frame, i + 1


def vp8_size(data: bytes, name: str) -> tuple[int, int]:
    """(width, height) of a VP8 key frame, checked as ``VP8GetInfo``."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: a WebP file with a corrupt VP8 frame "
                         "header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    w = (data[6] | data[7] << 8) & 0x3FFF
    h = (data[8] | data[9] << 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
            bits >> 5 >= len(data) or not w or not h:
        raise ValueError(f"{name}: a WebP file whose VP8 frame is not a "
                         "displayable key frame")
    return w, h


def vp8l_size(data: bytes, name: str) -> tuple[int, int, bool]:
    """(width, height, alpha_is_used) of a VP8L image header."""
    if len(data) < 5 or data[0] != VP8L_SIGNATURE or data[4] >> 5:
        raise ValueError(f"{name}: a WebP file with a corrupt VP8L header")
    v = int.from_bytes(data[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool((v >> 28) & 1)


# ---------------------------------------------------------------------------
# VP8 (RFC 6386; libwebp src/dec/vp8_dec.c, tree_dec.c, quant_dec.c,
# frame_dec.c, src/dsp/dec.c): a key frame to Y, U and V planes
# ---------------------------------------------------------------------------

# libwebp tree_dec.c: CoeffsProba0 and CoeffsUpdateProba [4][8][3][11],
# kBModesProba [10][10][9] (its mode order: DC, TM, VE, HE, RD, VR, LD, VL,
# HD, HU), quant_dec.c kDcTable [128] and kAcTable [128]
COEFF_PROBS = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080"
    "fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff808080"
    "0162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb808080"
    "01b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff808080"
    "01ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab8080808080"
    "0198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e08080808080"
    "0101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf80"
    "0195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff80"
    "0181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff80"
    "01c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc7808080"
    "01b6f9ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080"
    "019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe0808080"
    "0101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80"
    "015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff808080"
    "0118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4808080"
    "01bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff8080808080808080"
    "01e2ff8080808080808080f7c0ff8080808080808080f080ff8080808080808080"
    "0186fcffff808080808080d53efaffff808080808080375dff8080808080808080"
    "808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd880"
    "0170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff80"
    "0134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff80"
    "01b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb808080"
    "01def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff808080"
    "0179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd808080"
    "0101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"),
    np.uint8)
COEFF_UPDATE_PROBS = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "b0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffffffff"
    "fff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffff"
    "fff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffbfefefffffffffffffffffefffeffffffffffffffff"
    "fffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfeffffff"
    "fffeffffffffffffffffffdffefeffffffffffffffffeefdfefeffffffffffffff"
    "fff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffffffffff"
    "fffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcffffffffffffffffffffffffffffffffffffffffff"
    "fffefefffffffffffffffffdffffffffffffffffffffffffffffffffffffffffff"
    "fffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffffff"
    "fffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefeffffffffffff"
    "fffefefffffffffffffffffefefeffffffffffffffffffffffffffffffffffffff"
    "fffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdffffffffffffff"
    "fffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefeffffffffffff"
    "fffefcfffffffffffffffff8fefdfffffffffffffffffdfffefeffffffffffffff"
    "fffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffffffffffffff"
    "fffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffff"
    "fffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"),
    np.uint8)
BMODE_PROBS = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd"
    "110d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e37"
    "1388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa594"
    "48bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e"
    "6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d"
    "2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce1722"
    "2ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872"
    "282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01"
    "331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24"
    "ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c80"
    "1780cd2803097333c01206df572509733b4d40152f68372cda09363582e2405a46"
    "cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff"
    "1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b"
    "2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f72"
    "7315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f24a380"
    "44011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb87710"
    "56061c0540ff19f8013808118489ff3774803a0f145287391a7928a4321f899a85"
    "1923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d1015"
    "5b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033"
    "291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c"
    "8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a3"
    "70130c3dc380300418"),
    np.uint8)
DC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20,
    20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84,
    85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108,
    110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138,
    140, 143, 145, 148, 151, 154, 157], np.int32)
AC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125,
    128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167,
    170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221,
    225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284],
    np.int32)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
             (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 modes, in libwebp's order; the 16x16 and chroma modes share the
# first four numbers
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
# the tables in the order the C++ helper takes them
TABLES = np.concatenate([COEFF_PROBS, COEFF_UPDATE_PROBS, BMODE_PROBS])
_BMODES = BMODE_PROBS.tolist()


class BoolReader:
    """The VP8 boolean decoder (RFC 6386 section 7) over data[start:end],
    zeros past the end. ``eof`` is libwebp's: set once a bit is read with
    more than 8 (len - 1) bits shifted out."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.limit = 8 * (end - start) - 8
        self.value = (self._byte() << 8) | self._byte()
        self.range, self.count, self.shifted = 255, 0, 0
        self.eof = self.limit < 0

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < self.end else 0
        self.pos += 1
        return b

    def bit(self, prob: int) -> int:
        if self.shifted > self.limit:
            self.eof = True
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.shifted += 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self._byte()
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


class VP8Header:
    """The frame header of a VP8 key frame, parsed from its first
    partition (``VP8GetHeaders``): sizes, segmentation, the loop filter,
    the token partitions, the dequantisation factors and the coefficient
    probabilities; ``br`` is left at the first macroblock's modes."""

    def __init__(self, data: bytes, name: str = "<bytes>"):
        self.name = name
        self.width, self.height = vp8_size(data, name)
        bits = data[0] | data[1] << 8 | data[2] << 16
        first = bits >> 5
        if 10 + first > len(data):
            self.fail("its first partition runs past its end")
        br = self.br = BoolReader(data, 10, 10 + first)
        br.literal(2)                      # colour space, clamping type
        self.use_segment = br.bit(128)
        self.update_map, self.absolute = 0, 1
        self.quantizer, self.filter_strength = [0] * 4, [0] * 4
        self.segment_probs = [255] * 3
        if self.use_segment:
            self.update_map = br.bit(128)
            if br.bit(128):
                self.absolute = br.bit(128)
                self.quantizer = [br.signed(7) if br.bit(128) else 0
                                  for _ in range(4)]
                self.filter_strength = [br.signed(6) if br.bit(128) else 0
                                        for _ in range(4)]
            if self.update_map:
                self.segment_probs = [br.literal(8) if br.bit(128) else 255
                                      for _ in range(3)]
        self.simple = br.bit(128)
        self.level = br.literal(6)
        self.sharpness = br.literal(3)
        self.use_lf_delta = br.bit(128)
        self.ref_delta, self.mode_delta = [0] * 4, [0] * 4
        if self.use_lf_delta and br.bit(128):
            for deltas in (self.ref_delta, self.mode_delta):
                for i in range(4):
                    if br.bit(128):
                        deltas[i] = br.signed(6)
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        if br.eof:
            self.fail("its segment or filter header runs past its end")
        self.partitions = 1 << br.literal(2)
        pos, end = 10 + first, len(data)
        sizes = pos
        pos += 3 * (self.partitions - 1)
        if pos > end:
            self.fail("its partition sizes run past its end")
        self.parts = []
        for p in range(self.partitions - 1):
            size = int.from_bytes(data[sizes + 3 * p:sizes + 3 * p + 3],
                                  "little")
            size = min(size, end - pos)
            self.parts.append((pos, pos + size))
            pos += size
        if pos >= end:
            self.fail("a truncated WebP file (its last VP8 partition is "
                      "empty)")
        self.parts.append((pos, end))
        q0 = br.literal(7)
        dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
        self.dequant = []
        for s in range(4):
            q = q0
            if self.use_segment:
                q = self.quantizer[s] + (0 if self.absolute else q0)
            y2_ac = (int(AC_TABLE[_clip(q + dq[2], 127)]) * 101581) >> 16
            self.dequant.append((
                (int(DC_TABLE[_clip(q + dq[0], 127)]),
                 int(AC_TABLE[_clip(q, 127)])),
                (int(DC_TABLE[_clip(q + dq[1], 127)]) * 2, max(y2_ac, 8)),
                (int(DC_TABLE[_clip(q + dq[3], 117)]),
                 int(AC_TABLE[_clip(q + dq[4], 127)]))))
        br.bit(128)                        # refresh entropy probs: ignored
        probs = COEFF_PROBS.astype(np.int32).copy()
        for i, upd in enumerate(COEFF_UPDATE_PROBS):
            if br.bit(int(upd)):
                probs[i] = br.literal(8)
        self.probs = probs.reshape(4, 8, 3, 11).tolist()
        self.use_skip = br.bit(128)
        self.skip_prob = br.literal(8) if self.use_skip else 0
        self.mb_w, self.mb_h = (self.width + 15) >> 4, (self.height + 15) >> 4

    def fail(self, what: str):
        raise ValueError(f"{self.name}: a WebP file whose VP8 frame is "
                         f"corrupt: {what}")

    def filter_params(self, segment: int, i4x4: int):
        """(limit, interior limit, hev threshold) of
        ``PrecomputeFilterStrengths``; limit 0: no filtering."""
        level = self.level
        if self.use_segment:
            level = self.filter_strength[segment] + (
                0 if self.absolute else self.level)
        if self.use_lf_delta:
            level += self.ref_delta[0] + (self.mode_delta[0] if i4x4 else 0)
        level = _clip(level, 63)
        if level == 0:
            return 0, 0, 0
        ilevel = level
        if self.sharpness > 0:
            ilevel >>= 2 if self.sharpness > 4 else 1
            ilevel = min(ilevel, 9 - self.sharpness)
        ilevel = max(ilevel, 1)
        return 2 * level + ilevel, ilevel, 2 if level >= 40 else \
            1 if level >= 15 else 0


def _intra_modes(hdr: VP8Header):
    """Every macroblock's (segment, skip, i4x4, y modes [16] or [1], uv
    mode), parsed from the first partition in raster order."""
    br, mbs = hdr.br, []
    top = [B_DC] * (4 * hdr.mb_w)
    for _ in range(hdr.mb_h):
        left = [B_DC] * 4
        for mb_x in range(hdr.mb_w):
            seg = 0
            if hdr.update_map:
                p = hdr.segment_probs
                seg = (br.bit(p[1]) if not br.bit(p[0])
                       else br.bit(p[2]) + 2)
            skip = br.bit(hdr.skip_prob) if hdr.use_skip else 0
            i4x4 = not br.bit(145)
            if not i4x4:
                ymode = ((B_TM if br.bit(128) else B_HE) if br.bit(156)
                         else (B_VE if br.bit(163) else B_DC))
                modes = [ymode]
                top[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        p = _BMODES[(top[4 * mb_x + x] * 10 + m) * 9:]
                        if not br.bit(p[0]):
                            m = B_DC
                        elif not br.bit(p[1]):
                            m = B_TM
                        elif not br.bit(p[2]):
                            m = B_VE
                        elif not br.bit(p[3]):
                            m = (B_HE if not br.bit(p[4]) else
                                 B_RD if not br.bit(p[5]) else B_VR)
                        else:
                            m = (B_LD if not br.bit(p[6]) else
                                 B_VL if not br.bit(p[7]) else
                                 B_HD if not br.bit(p[8]) else B_HU)
                        top[4 * mb_x + x] = m
                    modes += top[4 * mb_x:4 * mb_x + 4]
                    left[y] = m
            uv = (B_DC if not br.bit(142) else B_VE if not br.bit(114)
                  else B_TM if br.bit(183) else B_HE)
            mbs.append((seg, skip, i4x4, modes, uv))
    return mbs


def _coeffs(br: BoolReader, probs, kind: int, ctx: int, dq, n: int,
            out: list, base: int) -> int:
    """``GetCoeffs``: one 4x4 block's tokens from coefficient ``n`` on,
    dequantised into out[base + raster index] (int16 wrap); returns the
    position after the last one read."""
    p = probs[kind][BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[kind][BANDS[n]][0]
        if not br.bit(p[2]):
            v, nxt = 1, 1
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                v = (5 + br.bit(159) if not br.bit(p[7])
                     else 7 + 2 * br.bit(165) + br.bit(145))
            else:
                bit1 = br.bit(p[8])
                cat = 2 * bit1 + br.bit(p[9 + bit1])
                v = 0
                for prob in CAT_PROBS[cat]:
                    v = v + v + br.bit(prob)
                v += 3 + (8 << cat)
            nxt = 2
        if br.bit(128):
            v = -v
        c = v * dq[n > 0]
        out[base + ZIGZAG[n]] = ((c + 32768) & 0xFFFF) - 32768
        n += 1
        p = probs[kind][BANDS[n]][nxt]
    return 16


def _wht(dc: list) -> list:
    """``TransformWHT``: the 16 luma DCs from the Y2 block."""
    tmp, out = [0] * 16, [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, \
            a3 + a2, a3 - a2
    for i in range(4):
        dc0 = tmp[4 * i] + 3
        a0, a1 = dc0 + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], dc0 - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [(a0 + a1) >> 3, (a3 + a2) >> 3,
                                (a0 - a1) >> 3, (a3 - a2) >> 3]
    return out


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _idct_add(c: list, base: int, blk: np.ndarray):
    """``TransformOne``: adds the inverse DCT of c[base:base + 16] to the
    4x4 uint8 view ``blk``."""
    tmp = [0] * 16
    for i in range(4):
        x0, x4, x8, x12 = c[base + i], c[base + 4 + i], c[base + 8 + i], \
            c[base + 12 + i]
        a, b = x0 + x8, x0 - x8
        cc, d = _mul2(x4) - _mul1(x12), _mul1(x4) + _mul2(x12)
        tmp[4 * i:4 * i + 4] = [a + d, b + cc, b - cc, a - d]
    out = np.empty((4, 4), np.int32)
    for i in range(4):
        dc = tmp[i] + 4
        a, b = dc + tmp[8 + i], dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        out[i] = [(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3, (a - d) >> 3]
    blk[:] = np.clip(blk.astype(np.int32) + out, 0, 255)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, tl: int) -> np.ndarray:
    """One 4x4 luma prediction (dec.c ``VE4`` ... ``HU4``, ``TM4``) from
    the 8 pixels above (top[4:8] the above-right ones), the 4 to the left
    and the corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    o = np.zeros((4, 4), np.int32)
    if mode == B_DC:
        o[:] = (sum(top[:4]) + sum(left) + 4) >> 3
    elif mode == B_TM:
        o[:] = np.clip(np.array(top[:4])[None] + np.array(left)[:, None]
                       - X, 0, 255)
    elif mode == B_VE:
        o[:] = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)]
    elif mode == B_HE:
        o[:] = np.array([_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                         _avg3(K, L, L)])[:, None]
    elif mode == B_RD:
        v = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)]
        for y in range(4):
            for x in range(4):
                o[y, x] = v[3 - y + x]
    elif mode == B_LD:
        v = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H)]
        for y in range(4):
            for x in range(4):
                o[y, x] = v[x + y]
    elif mode == B_VR:
        o[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
        o[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg3(B, C, D)]
        o[2] = [_avg3(J, I, X), o[0, 0], o[0, 1], o[0, 2]]
        o[3] = [_avg3(K, J, I), o[1, 0], o[1, 1], o[1, 2]]
    elif mode == B_VL:
        o[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
        o[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F)]
        o[2] = [o[0, 1], o[0, 2], o[0, 3], _avg3(E, F, G)]
        o[3] = [o[1, 1], o[1, 2], o[1, 3], _avg3(F, G, H)]
    elif mode == B_HD:
        o[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
        o[1] = [_avg2(J, I), _avg3(J, I, X), o[0, 0], o[0, 1]]
        o[2] = [_avg2(K, J), _avg3(K, J, I), o[1, 0], o[1, 1]]
        o[3] = [_avg2(L, K), _avg3(L, K, J), o[2, 0], o[2, 1]]
    else:                                  # B_HU
        o[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)]
        o[1] = [o[0, 2], o[0, 3], _avg2(K, L), _avg3(K, L, L)]
        o[2] = [o[1, 2], o[1, 3], L, L]
        o[3] = [L, L, L, L]
    return o


def _pred_block(mode: int, size: int, top, left, tl: int, mb_x: int,
                mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (DC with libwebp's
    ``CheckMode`` at the frame's edges, TM, V, H)."""
    shift = 5 if size == 16 else 4
    if mode == B_DC:
        if mb_x == 0 and mb_y == 0:
            dc = 128
        elif mb_y == 0:
            dc = (sum(left) * 2 + (1 << (shift - 1))) >> shift
        elif mb_x == 0:
            dc = (sum(top) * 2 + (1 << (shift - 1))) >> shift
        else:
            dc = (sum(top) + sum(left) + (1 << (shift - 1))) >> shift
        return np.full((size, size), dc, np.int32)
    t, lft = np.array(top, np.int32), np.array(left, np.int32)
    if mode == B_TM:
        return np.clip(t[None] + lft[:, None] - tl, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(t[None], (size, size))
    return np.broadcast_to(lft[:, None], (size, size))


def vp8_decode_numpy(data: bytes, name: str = "<bytes>",
                     info: dict | None = None):
    """A VP8 key frame (the ``VP8 `` chunk's payload) -> (Y [H, W], U, V
    [(H + 1) // 2, (W + 1) // 2]) uint8, as libwebp decodes it: modes and
    tokens, reconstruction from the unfiltered neighbours (127 above the
    frame, 129 left of it), then the loop filter over every macroblock in
    raster order. ``info``, when given, is filled with the paths taken
    (partitions, filter type and sharpness, the segments used, ...)."""
    hdr = VP8Header(data, name)
    mbs = _intra_modes(hdr)
    mb_w, mb_h = hdr.mb_w, hdr.mb_h
    parts = [BoolReader(data, a, b) for a, b in hdr.parts]
    planes = [np.zeros((16 * mb_h, 16 * mb_w), np.uint8),
              np.zeros((8 * mb_h, 8 * mb_w), np.uint8),
              np.zeros((8 * mb_h, 8 * mb_w), np.uint8)]
    top_nz = [[0] * (4 * mb_w), [0] * (2 * mb_w), [0] * (2 * mb_w),
              [0] * mb_w]
    filters, skipped = [], 0
    for mb_y in range(mb_h):
        br = parts[mb_y & (hdr.partitions - 1)]
        left_nz = [[0] * 4, [0] * 2, [0] * 2, [0]]
        for mb_x in range(mb_w):
            seg, skip, i4x4, modes, uv = mbs[mb_y * mb_w + mb_x]
            coeffs = [0] * 384
            if hdr.use_skip and skip:
                for k in range(3):
                    left_nz[k][:] = [0] * len(left_nz[k])
                    n = len(left_nz[k])
                    top_nz[k][n * mb_x:n * mb_x + n] = [0] * n
                if not i4x4:
                    left_nz[3][0] = top_nz[3][mb_x] = 0
                coded = False
            else:
                coded = _residuals(br, hdr, seg, i4x4, coeffs, top_nz,
                                   left_nz, mb_x)
            skipped += not coded
            limit, ilevel, hev = hdr.filter_params(seg, i4x4)
            filters.append((limit, ilevel, hev, i4x4 or coded))
            _reconstruct(planes, hdr, mb_x, mb_y, i4x4, modes, uv, coeffs)
    if hdr.br.eof or any(p.eof for p in parts):
        raise ValueError(f"{name}: a truncated WebP file (premature end of "
                         "a VP8 partition)")
    if hdr.filter_type:
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                limit, ilevel, hev, inner = filters[mb_y * mb_w + mb_x]
                if limit:
                    _filter_mb(planes, hdr.filter_type == 1, mb_x, mb_y,
                               limit, ilevel, hev, inner)
    if info is not None:
        info.update(
            partitions=hdr.partitions, filter_type=hdr.filter_type,
            sharpness=hdr.sharpness, level=hdr.level,
            segments=sorted({m[0] for m in mbs}), update_map=hdr.update_map,
            i4x4=any(m[2] for m in mbs), i16=not all(m[2] for m in mbs),
            skip_proba=hdr.use_skip, skipped=skipped,
            lf_delta=hdr.use_lf_delta)
    W, H = hdr.width, hdr.height
    return (planes[0][:H, :W].copy(), planes[1][:(H + 1) // 2,
                                                 :(W + 1) // 2].copy(),
            planes[2][:(H + 1) // 2, :(W + 1) // 2].copy())


def _residuals(br, hdr, seg, i4x4, coeffs, top_nz, left_nz, mb_x) -> bool:
    """``ParseResiduals``: the macroblock's 25 blocks of tokens into
    ``coeffs`` (16 luma, 4 U, 4 V blocks of 16, the Y2 block's WHT spread
    into the luma DCs), the non-zero contexts updated; returns whether any
    block has a coefficient (libwebp's ``non_zero_y | non_zero_uv``)."""
    (y1, y2, uvq), probs = hdr.dequant[seg], hdr.probs
    nonzero = 0
    if not i4x4:
        dc = [0] * 16
        ctx = top_nz[3][mb_x] + left_nz[3][0]
        nz = _coeffs(br, probs, 1, ctx, y2, 0, dc, 0)
        top_nz[3][mb_x] = left_nz[3][0] = int(nz > 0)
        for i, v in enumerate(_wht(dc)):
            coeffs[16 * i] = ((v + 32768) & 0xFFFF) - 32768
        first, kind = 1, 0
    else:
        first, kind = 0, 3
    for y in range(4):
        for x in range(4):
            b = 16 * (4 * y + x)
            ctx = top_nz[0][4 * mb_x + x] + left_nz[0][y]
            nz = _coeffs(br, probs, kind, ctx, y1, first, coeffs, b)
            top_nz[0][4 * mb_x + x] = left_nz[0][y] = int(nz > first)
            nonzero |= nz > 1 or coeffs[b] != 0
    for ch in (1, 2):
        for y in range(2):
            for x in range(2):
                b = 256 + 64 * (ch - 1) + 16 * (2 * y + x)
                ctx = top_nz[ch][2 * mb_x + x] + left_nz[ch][y]
                nz = _coeffs(br, probs, 2, ctx, uvq, 0, coeffs, b)
                top_nz[ch][2 * mb_x + x] = left_nz[ch][y] = int(nz > 0)
                nonzero |= nz > 1 or coeffs[b] != 0
    return bool(nonzero)


def _edges(plane, x0, y0, size, mb_x, mb_y, right=0):
    """The pixels above (with ``right`` more to the right) and to the left
    of the block at (x0, y0) and the corner, with libwebp's frame edges:
    127 above the frame (the corner too), 129 left of it (the corner too
    below the first row); the above-right pixels past the frame's last
    macroblock repeat its last pixel above."""
    if mb_y == 0:
        top, tl = [127] * (size + right), 127
    else:
        row = plane[y0 - 1]
        top = [int(v) for v in row[x0:x0 + size]]
        if right:
            if x0 + size < plane.shape[1]:
                top += [int(v) for v in row[x0 + size:x0 + size + right]]
            else:
                top += [top[-1]] * right
        tl = int(row[x0 - 1]) if mb_x > 0 else 129
    left = ([int(v) for v in plane[y0:y0 + size, x0 - 1]] if mb_x > 0
            else [129] * size)
    return top, left, tl


def _reconstruct(planes, hdr, mb_x, mb_y, i4x4, modes, uv, coeffs):
    """Prediction plus residue of one macroblock, into the unfiltered
    planes (which libwebp's predictions read)."""
    Y = planes[0]
    x0, y0 = 16 * mb_x, 16 * mb_y
    if not i4x4:
        top, left, tl = _edges(Y, x0, y0, 16, mb_x, mb_y)
        Y[y0:y0 + 16, x0:x0 + 16] = _pred_block(modes[0], 16, top, left,
                                                tl, mb_x, mb_y)
        for n in range(16):
            bx, by = x0 + 4 * (n & 3), y0 + 4 * (n >> 2)
            _idct_add(coeffs, 16 * n, Y[by:by + 4, bx:bx + 4])
    else:
        mtop, mleft, mtl = _edges(Y, x0, y0, 16, mb_x, mb_y, right=4)
        for n in range(16):
            sx, sy = n & 3, n >> 2
            bx, by = x0 + 4 * sx, y0 + 4 * sy
            if sy == 0:
                top = mtop[4 * sx:4 * sx + 8]
                tl = mtl if sx == 0 else mtop[4 * sx - 1]
            else:
                row = Y[by - 1]
                top = [int(v) for v in row[bx:bx + 4]]
                top += ([int(v) for v in row[bx + 4:bx + 8]] if sx < 3
                        else mtop[16:20])
                tl = int(row[bx - 1]) if sx or mb_x else 129
            left = ([int(v) for v in Y[by:by + 4, bx - 1]] if sx or mb_x
                    else [129] * 4)
            Y[by:by + 4, bx:bx + 4] = _pred4(modes[n], top, left, tl)
            _idct_add(coeffs, 16 * n, Y[by:by + 4, bx:bx + 4])
    for ch in (1, 2):
        P = planes[ch]
        cx, cy = 8 * mb_x, 8 * mb_y
        top, left, tl = _edges(P, cx, cy, 8, mb_x, mb_y)
        P[cy:cy + 8, cx:cx + 8] = _pred_block(uv, 8, top, left, tl, mb_x,
                                              mb_y)
        for n in range(4):
            bx, by = cx + 4 * (n & 1), cy + 4 * (n >> 1)
            _idct_add(coeffs, 256 + 64 * (ch - 1) + 16 * n,
                      P[by:by + 4, bx:bx + 4])


def _filter_edge(seg: np.ndarray, kind: str, limit: int, ilevel: int,
                 hev_t: int):
    """The loop filter across one edge: ``seg`` [n, 8] is a view of the
    pixels p3 p2 p1 p0 | q0 q1 q2 q3 across it (dec.c ``SimpleVFilter16``,
    ``FilterLoop26``, ``FilterLoop24``): "simple", "mb" or "inner"."""
    s = seg.astype(np.int32)
    p3, p2, p1, p0, q0, q1, q2, q3 = s.T
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * limit + 1
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1),
                     (q1, q0)):
            mask &= np.abs(a - b) <= ilevel
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    out = s.copy()
    # DoFilter2: the simple filter and high edge variance
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    m = mask & hev
    out[m, 3] = np.clip(p0 + a2, 0, 255)[m]
    out[m, 4] = np.clip(q0 - a1, 0, 255)[m]
    m = mask & ~hev
    if kind == "mb":                       # DoFilter6
        w = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * w + 63) >> 7, (18 * w + 63) >> 7, \
            (9 * w + 63) >> 7
        for col, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1),
                       (4, q0 - a1), (5, q1 - a2), (6, q2 - a3)):
            out[m, col] = np.clip(v, 0, 255)[m]
    elif kind == "inner":                  # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16,
                                                         15)
        a3 = (a1 + 1) >> 1
        for col, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1),
                       (5, q1 - a3)):
            out[m, col] = np.clip(v, 0, 255)[m]
    seg[:] = out


def _filter_mb(planes, simple: bool, mb_x: int, mb_y: int, limit: int,
               ilevel: int, hev: int, inner: bool):
    """``DoFilter`` of one macroblock: its left edge, inner vertical
    edges, top edge and inner horizontal edges, luma (and chroma for the
    normal filter)."""
    jobs = [(planes[0], 16)] + ([] if simple else [(planes[1], 8),
                                                   (planes[2], 8)])
    mb_kind, in_kind = ("simple", "simple") if simple else ("mb", "inner")
    steps = []
    if mb_x > 0:
        steps.append(("v", 0, mb_kind, limit + 4))
    if inner:
        steps.append(("v", 4, in_kind, limit))
    if mb_y > 0:
        steps.append(("h", 0, mb_kind, limit + 4))
    if inner:
        steps.append(("h", 4, in_kind, limit))
    for axis, first, kind, lim in steps:
        for plane, size in jobs:
            x0, y0 = size * mb_x, size * mb_y
            offsets = [first] if first == 0 else list(range(4, size, 4))
            for off in offsets:
                if axis == "v":
                    seg = plane[y0:y0 + size, x0 + off - 4:x0 + off + 4]
                else:
                    seg = plane[y0 + off - 4:y0 + off + 4, x0:x0 + size].T
                _filter_edge(seg, kind, lim, ilevel, hev)


# ---------------------------------------------------------------------------
# libwebp's fancy upsampling (src/dsp/upsampling.c, src/dec/io_dec.c) and
# YUV to RGB (src/dsp/yuv.h)
# ---------------------------------------------------------------------------


def _upsample_rows(top: np.ndarray, cur: np.ndarray, W: int, bottom: bool):
    """``UPSAMPLE_FUNC`` of one chroma row pair, one output row of W: the
    upper one (``bottom`` False) or the lower one."""
    tl, l = top.astype(np.int32), cur.astype(np.int32)
    if bottom:
        tl, l = l, tl                      # the roles swap below
    out = np.empty(W, np.int32)
    out[0] = (3 * tl[0] + l[0] + 2) >> 2
    pairs = (W - 1) >> 1
    if pairs:
        a, b = tl[:pairs], tl[1:pairs + 1]      # near row: left, right
        c, d = l[:pairs], l[1:pairs + 1]        # far row: left, right
        avg = a + b + c + d + 8
        diag_bc = (avg + 2 * (b + c)) >> 3
        diag_ad = (avg + 2 * (a + d)) >> 3
        out[1:2 * pairs:2] = (diag_bc + a) >> 1
        out[2:2 * pairs + 1:2] = (diag_ad + b) >> 1
    if not W & 1:
        out[W - 1] = (3 * tl[pairs] + l[pairs] + 2) >> 2
    return out


def upsample_numpy(c: np.ndarray, W: int, H: int) -> np.ndarray:
    """A chroma plane [(H + 1) // 2, (W + 1) // 2] -> [H, W] by libwebp's
    fancy upsampler: row 0 from chroma row 0 alone, rows 2k - 1 and 2k
    from chroma rows k - 1 and k (weights 3:1 toward the nearer one, with
    its rounding), the last row of an even height from the last chroma
    row alone."""
    out = np.empty((H, W), np.int32)
    out[0] = _upsample_rows(c[0], c[0], W, False)
    for k in range(1, (H + 1) // 2 + 1):
        if 2 * k - 1 >= H:
            break
        if k == (H + 1) // 2:          # the last row of an even height
            out[2 * k - 1] = _upsample_rows(c[k - 1], c[k - 1], W, False)
            break
        out[2 * k - 1] = _upsample_rows(c[k - 1], c[k], W, False)
        if 2 * k < H:
            out[2 * k] = _upsample_rows(c[k - 1], c[k], W, True)
    return out


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb_numpy(y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> np.ndarray:
    """Y [H, W], U and V [(H + 1) // 2, (W + 1) // 2] -> RGB [H, W, 3]
    uint8: the fancy upsampler, then ``VP8YUVToR/G/B`` (14-bit fixed
    point)."""
    H, W = y.shape
    uu, vv = upsample_numpy(u, W, H), upsample_numpy(v, W, H)
    yy = y.astype(np.int32)
    r = _clip8(_mult_hi(yy, 19077) + _mult_hi(vv, 26149) - 14234)
    g = _clip8(_mult_hi(yy, 19077) - _mult_hi(uu, 6419)
               - _mult_hi(vv, 13320) + 8708)
    b = _clip8(_mult_hi(yy, 19077) + _mult_hi(uu, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# VP8L (RFC 9649; libwebp src/dec/vp8l_dec.c, src/dsp/lossless.c)
# ---------------------------------------------------------------------------

CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# kCodeToPlane: the 120 short distance codes, (y << 4) | (8 - x)
CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a24"
    "2c58454b343c035759131d565a232d444c555b333d68026769121e666a222e545c"
    "434d656b323e78017779535d111f646c424e767a212f757b313f636d525e00747c"
    "414f1020626e30737d515f40727e616f50717f6070")
ALPHABET = (256 + 24, 256, 256, 256, 40)   # green (+ cache), R, B, A, dist


class _BitReader:
    """VP8L's LSB-first bit reader; ``over`` is libwebp's end of stream:
    more bits read than max(64, 8 * len)."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data, self.pos = data, pos_bits
        self.limit = max(64, 8 * len(data))

    def read(self, n: int) -> int:
        if not n:
            return 0
        i = self.pos >> 3
        v = int.from_bytes(self.data[i:i + 4], "little") >> (self.pos & 7)
        self.pos += n
        return v & ((1 << n) - 1)

    @property
    def over(self) -> bool:
        return self.pos > self.limit


class _Prefix:
    """A canonical prefix code from its code lengths (``BuildHuffmanTable``:
    one used symbol is a code of no bits; otherwise the code must be
    complete)."""

    def __init__(self, lengths: list, what: str):
        used = [s for s, n in enumerate(lengths) if n]
        if not used or max(lengths) > 15:
            raise ValueError(f"an invalid VP8L prefix code ({what})")
        self.single = used[0] if len(used) == 1 else None
        if self.single is not None:
            return
        self.count = [0] * 16
        for n in lengths:
            self.count[n] += 1
        left = 1
        for n in range(1, 16):
            left = 2 * left - self.count[n]
            if left < 0:
                raise ValueError(f"an invalid VP8L prefix code ({what})")
        if left:
            raise ValueError(f"an incomplete VP8L prefix code ({what})")
        self.symbols = sorted(used, key=lambda s: (lengths[s], s))

    def read(self, br: _BitReader) -> int:
        if self.single is not None:
            return self.single
        code = first = index = 0
        for n in range(1, 16):
            code |= br.read(1)
            c = self.count[n]
            if code - first < c:
                return self.symbols[index + code - first]
            index += c
            first = (first + c) << 1
            code <<= 1
        raise ValueError("an invalid VP8L prefix code")


def _read_code(br: _BitReader, size: int, info: dict) -> _Prefix:
    """``ReadHuffmanCode``: a simple code (one or two symbols) or code
    lengths coded with the code-length code."""
    lengths = [0] * max(size, 256)
    if br.read(1):
        info["simple_codes"] = info.get("simple_codes", 0) + 1
        n = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _Prefix(lengths[:size], "simple")
    info["normal_codes"] = info.get("normal_codes", 0) + 1
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[CODE_LENGTH_ORDER[i]] = br.read(3)
    clc = _Prefix(cl, "code lengths")
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError("a VP8L code with too many code lengths")
    else:
        max_symbol = size
    sym, prev = 0, 8
    while sym < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = clc.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > size:
                raise ValueError("a VP8L code length repeat past the "
                                 "alphabet")
            lengths[sym:sym + repeat] = [prev if c == 16 else 0] * repeat
            sym += repeat
    if br.over:
        raise ValueError("a truncated VP8L stream")
    return _Prefix(lengths[:size], "normal")


def _copy_distance(sym: int, br: _BitReader) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_image(br: _BitReader, w: int, h: int, level0: bool,
                  info: dict) -> tuple[list, list]:
    """``DecodeImageStream``: (the pixels [w * h] as ARGB ints, the
    transforms read, for level 0). Entropy-coded image: transforms (level
    0 only), the colour cache, meta prefix codes (level 0 only), the
    prefix code groups, then LZ77-coded pixels."""
    transforms = []
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("a VP8L transform used twice")
            seen.add(kind)
            t = {"kind": kind, "xsize": w}
            if kind in (0, 1):
                t["bits"] = br.read(3) + 2
                t["data"] = _decode_image(
                    br, _subsample(w, t["bits"]), _subsample(h, t["bits"]),
                    False, info)[0]
            elif kind == 3:
                n = br.read(8) + 1
                t["bits"] = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 \
                    else 3
                pal = _decode_image(br, n, 1, False, info)[0]
                t["colours"] = n
                t["data"] = _expand_palette(pal, 1 << (8 >> t["bits"]))
                w = _subsample(w, t["bits"])
            transforms.append(t)
            info.setdefault("transforms", []).append(kind)
            if kind == 3:
                info.setdefault("palette_bits", []).append(t["bits"])
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"a VP8L colour cache of {cache_bits} bits")
        info.setdefault("cache_bits", []).append(cache_bits)
    meta_bits, meta = 0, None
    groups = 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _subsample(w, meta_bits)
        img = _decode_image(br, mw, _subsample(h, meta_bits), False, info)[0]
        meta = [(p >> 8) & 0xFFFF for p in img]
        groups = max(meta) + 1
        info["meta_codes"] = info.get("meta_codes", 0) + groups
    codes = []
    for _ in range(groups):
        codes.append([_read_code(br, ALPHABET[j] + (
            (1 << cache_bits) if j == 0 and cache_bits else 0), info)
            for j in range(5)])
    px = [0] * (w * h)
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    i, n = 0, w * h
    last = 0                         # pixels inserted into the cache
    cache_limit = 280 + (1 << cache_bits if cache_bits else 0)
    while i < n:
        x, y = i % w, i // w
        g = codes[meta[(y >> meta_bits) * _subsample(w, meta_bits)
                       + (x >> meta_bits)] if meta else 0]
        code = g[0].read(br)
        if code < 256:
            r, b, a = g[1].read(br), g[2].read(br), g[3].read(br)
            px[i] = (a << 24) | (r << 16) | (code << 8) | b
            i += 1
        elif code < 280:
            length = _copy_distance(code - 256, br)
            dsym = g[4].read(br)
            dcode = _copy_distance(dsym, br)
            if dcode > 120:
                dist = dcode - 120
            else:
                v = CODE_TO_PLANE[dcode - 1]
                dist = max(1, (v >> 4) * w + 8 - (v & 15))
            if br.over:
                break
            if dist > i or length > n - i:
                raise ValueError("a VP8L backward reference outside the "
                                 "image")
            for k in range(length):
                px[i + k] = px[i + k - dist]
            i += length
        elif code < cache_limit:
            while last < i:
                cache[((0x1E35A7BD * px[last]) & 0xFFFFFFFF) >> shift] = \
                    px[last]
                last += 1
            px[i] = cache[code - 280]
            i += 1
        else:
            raise ValueError("a VP8L symbol past the alphabet")
        if br.over:
            break
        if cache is not None:
            while last < i:
                cache[((0x1E35A7BD * px[last]) & 0xFFFFFFFF) >> shift] = \
                    px[last]
                last += 1
    if br.over:
        raise ValueError("a truncated VP8L stream")
    return px, transforms


def _expand_palette(pal: list, size: int) -> list:
    """``ExpandColorMap``: the palette's entries are deltas of the one
    before, byte by byte; entries past it are 0."""
    out = [0] * size
    prev = 0
    for k, p in enumerate(pal):
        cur = 0
        for s in (0, 8, 16, 24):
            cur |= ((((p >> s) & 255) + ((prev >> s) & 255)) & 255) << s
        out[k] = prev = cur if k else p
    return out


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(p: int):
    return (p >> 24, (p >> 16) & 255, (p >> 8) & 255, p & 255)


def _pack(c) -> int:
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _s8(v: int) -> int:
    """The low byte of v as a signed 8-bit value."""
    v &= 255
    return v - 256 if v & 128 else v


def _predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    """The 14 predictors of ``VP8LPredictorsAdd`` (14 and 15: black)."""
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:
        pa_pb = sum(abs(lv - tlv) - abs(tv - tlv) for lv, tv, tlv in zip(
            _channels(L), _channels(T), _channels(TL)))
        return T if pa_pb <= 0 else L
    if mode == 12:
        return _pack([min(max(lv + tv - tlv, 0), 255) for lv, tv, tlv in zip(
            _channels(L), _channels(T), _channels(TL))])
    if mode == 13:
        out = []
        for a, b in zip(_channels(_avg(L, T)), _channels(TL)):
            out.append(min(max(a + int((a - b) / 2), 0), 255))
        return _pack(out)
    return 0xFF000000


def _inverse(t: dict, px: list, w: int, h: int) -> list:
    """One inverse transform of ``px`` ([xsize * h] after it)."""
    kind = t["kind"]
    if kind == 2:                          # subtract green
        out = []
        for p in px:
            g = (p >> 8) & 255
            out.append((p & 0xFF00FF00) | ((((p >> 16) + g) & 255) << 16)
                       | (((p & 255) + g) & 255))
        return out
    if kind == 0:                          # predictor
        bits, data = t["bits"], t["data"]
        tiles = _subsample(w, bits)
        out = [0] * (w * h)
        for y in range(h):
            for x in range(w):
                i = y * w + x
                if y == 0:
                    pred = 0xFF000000 if x == 0 else out[i - 1]
                elif x == 0:
                    pred = out[i - w]
                else:
                    mode = (data[(y >> bits) * tiles + (x >> bits)] >> 8) & 15
                    pred = _predict(mode, out[i - 1], out[i - w],
                                    out[i - w + 1], out[i - w - 1])
                out[i] = _add(px[i], pred)
        return out
    if kind == 1:                          # cross colour
        bits, data = t["bits"], t["data"]
        tiles = _subsample(w, bits)
        out = []
        for i, p in enumerate(px):
            y, x = divmod(i, w)
            m = data[(y >> bits) * tiles + (x >> bits)]
            g2r, g2b, r2b = _s8(m), _s8(m >> 8), _s8(m >> 16)
            g = _s8(p >> 8)
            r = (((p >> 16) & 255) + ((g2r * g) >> 5)) & 255
            b = ((p & 255) + ((g2b * g) >> 5) + ((r2b * _s8(r)) >> 5)) & 255
            out.append((p & 0xFF00FF00) | (r << 16) | b)
        return out
    # colour indexing, pixels bundled at 8 >> bits bits each
    bits, pal = t["bits"], t["data"]
    pw = _subsample(w, bits)
    per, nbits = 1 << bits, 8 >> bits
    out = [0] * (w * h)
    for y in range(h):
        for x in range(w):
            g = (px[y * pw + (x >> bits)] >> 8) & 255
            idx = (g >> (nbits * (x & (per - 1)))) & ((1 << nbits) - 1)
            out[y * w + x] = pal[idx]
    return out


def vp8l_decode_numpy(data: bytes, width: int | None = None,
                      height: int | None = None,
                      info: dict | None = None) -> np.ndarray:
    """A VP8L image -> ARGB [H, W] uint32. ``data`` is a ``VP8L`` chunk's
    payload (its 5-byte header gives the size) or, with ``width`` and
    ``height``, a headerless image stream (an ``ALPH`` chunk's)."""
    info = {} if info is None else info
    if width is None:
        width, height, _ = vp8l_size(data, "<bytes>")
        br = _BitReader(data, 40)
    else:
        br = _BitReader(data, 0)
    px, transforms = _decode_image(br, width, height, True, info)
    for t in reversed(transforms):
        px = _inverse(t, px, t["xsize"], height)
    return np.array(px, np.uint32).reshape(height, width)


# ---------------------------------------------------------------------------
# The alpha plane (libwebp src/dec/alpha_dec.c, src/dsp/filters.c)
# ---------------------------------------------------------------------------


def alpha_unfilter_numpy(a: np.ndarray, method: int) -> np.ndarray:
    """Undo the ``ALPH`` filter (0 none, 1 horizontal, 2 vertical, 3
    gradient) of uint8 [H, W], row by row: the first row is horizontal
    from 0 for every filter; later rows start from the pixel above."""
    a = a.astype(np.int32)
    H, W = a.shape
    out = np.zeros((H, W), np.int32)
    if method == 0:
        return a.astype(np.uint8)
    for y in range(H):
        if y == 0 or method == 1:
            pred = 0 if y == 0 else out[y - 1, 0]
            for x in range(W):
                out[y, x] = (pred + a[y, x]) & 255
                pred = out[y, x]
        elif method == 2:
            out[y] = (out[y - 1] + a[y]) & 255
        else:
            left = top_left = out[y - 1, 0]
            for x in range(W):
                top = out[y - 1, x]
                g = left + top - top_left
                left = (a[y, x] + min(max(g, 0), 255)) & 255
                top_left = top
                out[y, x] = left
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# The C++ helper (csrc/webp_decode.cpp) and the frame as the readers give it
# ---------------------------------------------------------------------------

# the helper's status codes
HELPER_ERRORS = {
    1: "a truncated WebP file (premature end of a VP8 partition)",
    2: "a WebP file whose VP8 frame is corrupt: its first partition runs "
       "past its end",
    3: "a WebP file whose VP8 frame is corrupt: its segment or filter "
       "header runs past its end",
    4: "a WebP file whose VP8 frame is corrupt: its partition sizes run "
       "past its end",
    5: "a truncated WebP file (its last VP8 partition is empty)",
    6: "a WebP file whose VP8 frame is not a displayable key frame",
    11: "a WebP file with a corrupt VP8L stream: an invalid prefix code",
    12: "a WebP file with a corrupt VP8L stream: a transform used twice",
    13: "a WebP file with a corrupt VP8L stream: an invalid colour cache",
    14: "a WebP file with a corrupt VP8L stream: too many code lengths",
    15: "a WebP file with a corrupt VP8L stream: a backward reference "
        "outside the image",
    16: "a truncated WebP file (premature end of its VP8L stream)",
    17: "a WebP file with a corrupt VP8L stream: a symbol past the alphabet",
}


def _bind(lib):
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.webp_vp8.restype = i64
    lib.webp_vp8.argtypes = [ctypes.c_char_p, i64, p_u8, p_u8, p_u8, p_u8]
    lib.webp_yuv_rgb.restype = None
    lib.webp_yuv_rgb.argtypes = [p_u8, p_u8, p_u8, i64, i64, p_u8]
    lib.webp_vp8l.restype = i64
    lib.webp_vp8l.argtypes = [ctypes.c_char_p, i64, i64, i64, i64, p_u32]
    lib.webp_alpha_unfilter.restype = None
    lib.webp_alpha_unfilter.argtypes = [p_u8, i64, i64, i64]


def _lib():
    from . import image_io             # image_io imports this module

    return image_io._helper(
        "webp_decode", _bind,
        "WebP frames are decoded with the numpy references, whose VP8 and "
        "VP8L loops run in Python and are many times slower")


def _check(status: int, name: str):
    if status:
        raise ValueError(f"{name}: {HELPER_ERRORS.get(status, status)}")


def vp8_decode(data: bytes, name: str = "<bytes>"):
    """``vp8_decode_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None:
        return vp8_decode_numpy(data, name)
    w, h = vp8_size(data, name)
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    _check(lib.webp_vp8(data, len(data), TABLES, y, u, v), name)
    return y, u, v


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``yuv_to_rgb_numpy`` through the C++ helper when it builds."""
    H, W = y.shape
    if u.shape != ((H + 1) // 2, (W + 1) // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes {u.shape}, {v.shape} do not fit "
                         f"a {W}x{H} frame")
    lib = _lib()
    if lib is None:
        return yuv_to_rgb_numpy(y, u, v)
    rgb = np.empty((H, W, 3), np.uint8)
    lib.webp_yuv_rgb(*(np.ascontiguousarray(p, np.uint8) for p in (y, u, v)),
                     W, H, rgb)
    return rgb


def vp8l_decode(data: bytes, width: int | None = None,
                height: int | None = None,
                name: str = "<bytes>") -> np.ndarray:
    """``vp8l_decode_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None:
        try:
            return vp8l_decode_numpy(data, width, height)
        except ValueError as e:
            raise ValueError(f"{name}: a WebP file with {e}") from None
    start = 0
    if width is None:
        width, height, _ = vp8l_size(data, name)
        start = 40
    argb = np.empty((height, width), np.uint32)
    _check(lib.webp_vp8l(data, len(data), start, width, height, argb), name)
    return argb


def alpha_unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """``alpha_unfilter_numpy`` through the C++ helper when it builds."""
    lib = _lib()
    if lib is None:
        return alpha_unfilter_numpy(a, method)
    out = np.array(a, np.uint8, order="C")
    lib.webp_alpha_unfilter(out, out.shape[1], out.shape[0], method)
    return out


def decode_alpha(alph: bytes, width: int, height: int,
                 name: str = "<bytes>") -> np.ndarray:
    """An ``ALPH`` chunk's payload -> the alpha plane [height, width]
    uint8 (``ALPHInit`` / ``ALPHDecode``): a header byte (compression 0
    raw or 1 VP8L, filter 0-3, pre-processing 0-1, reserved 0), then the
    filtered plane raw or as the green of a headerless VP8L stream."""
    if len(alph) <= 1:
        raise ValueError(f"{name}: a WebP file with an empty ALPH chunk")
    method, filt = alph[0] & 3, (alph[0] >> 2) & 3
    if method > 1 or (alph[0] >> 4) & 3 > 1 or alph[0] >> 6:
        raise ValueError(f"{name}: a WebP file with an invalid ALPH header "
                         f"{alph[0]:#x}")
    if method == 0:
        if len(alph) - 1 < width * height:
            raise ValueError(f"{name}: a truncated WebP file (its raw "
                             "alpha plane is short)")
        a = np.frombuffer(alph, np.uint8, width * height, 1).reshape(
            height, width)
    else:
        a = ((vp8l_decode(alph[1:], width, height, name) >> 8)
             & 255).astype(np.uint8)
    return alpha_unfilter(a, filt)


def frame_rgba(frame: Frame, name: str = "<bytes>") -> np.ndarray:
    """The frame's pixels [h, w, 4] uint8, not premultiplied: a VP8 frame
    through the fancy upsampler, its ``ALPH`` plane (decoded whenever
    present, as libwebp decodes it) or 255; a VP8L frame's ARGB."""
    rgba = np.empty((frame.height, frame.width, 4), np.uint8)
    if frame.vp8 is not None:
        rgba[..., :3] = yuv_to_rgb(*vp8_decode(frame.vp8, name))
        rgba[..., 3] = (255 if frame.alph is None else decode_alpha(
            frame.alph, frame.width, frame.height, name))
        return rgba
    argb = vp8l_decode(frame.vp8l, name=name)
    for c, s in enumerate((16, 8, 0, 24)):
        rgba[..., c] = (argb >> s) & 255
    return rgba


def _canvas(data: bytes, name: str):
    """(the parsed file, the first frame on its zeroed canvas [H, W, 4],
    as ``WebPAnimDecoder`` composes a key frame)."""
    f = WebPFile(data, name)
    W, H = f.canvas
    fr = f.frame
    px = frame_rgba(fr, name)
    if (fr.width, fr.height) == (W, H):
        return f, px
    canvas = np.zeros((H, W, 4), np.uint8)
    canvas[fr.y:fr.y + fr.height, fr.x:fr.x + fr.width] = px
    return f, canvas


def decode_webp(data: bytes, name: str = "<bytes>",
                reader: str = "pillow") -> np.ndarray:
    """A WebP file -> uint8 [H, W, 3]: Pillow's ``convert("RGB")`` of its
    first frame on its canvas, which OpenCV's ``imread`` (``reader=
    "opencv"``) gives too."""
    return np.ascontiguousarray(_canvas(data, name)[1][..., :3])


def webp_raw(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """``np.asarray(Image.open(...))`` of a WebP file: [H, W, 4] where
    libwebp reports alpha (Pillow's "RGBA"), else [H, W, 3]."""
    f, px = _canvas(data, name)
    return np.ascontiguousarray(px if f.has_alpha else px[..., :3])


def webp_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """(width, height) of the canvas: Pillow's ``Image.open(...).size``."""
    return WebPFile(data, name).canvas
