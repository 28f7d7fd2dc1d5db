"""PDF text extraction.

Mirrors the reference's extractor shape
(src/OmniRecall.Api/Services/PdfPigTextExtractor.cs:16-56): extract text from
the PDF; when parsing fails or the result is shorter than
``Ocr:PdfTextMinChars`` (default 120), fall back to the pluggable OCR
extractor (``NoOpOcrTextExtractor`` by default, returning empty — reference
NoOpOcrTextExtractor.cs:9).

No third-party PDF library is available in this environment, so the built-in
parser handles machine-generated PDFs directly:

- Flate-compressed or plain content streams with ``Tj``/``TJ``/``'``/``"``
  text-showing operators,
- literal strings (escape sequences, octal codes) AND hex strings ``<...>``,
- ``/ToUnicode`` CMaps (``bfchar``/``bfrange``) resolved per font through
  the page ``/Font`` resource dictionaries and ``Tf`` operator tracking, so
  CID/Type0 fonts with 2-byte codes (the common "copy-paste works" subset
  PdfPig handles, PdfPigTextExtractor.cs:43-56) extract correctly,
- PDFDocEncoding/latin-1 fallback for simple fonts without a CMap.

Predefined CMaps without embedded ToUnicode data (rare in generated PDFs)
still fall through to OCR/empty, like a PdfPig parse failure would.
"""

from __future__ import annotations

import logging
import re
import zlib

logger = logging.getLogger(__name__)


class NoOpOcrTextExtractor:
    def extract_text(self, data: bytes) -> str:
        return ""


_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
_OBJ_RE = re.compile(rb"(\d+)\s+\d+\s+obj(.*?)endobj", re.DOTALL)
_TOUNICODE_RE = re.compile(rb"/ToUnicode\s+(\d+)\s+\d+\s+R")
_FONT_RES_RE = re.compile(rb"/Font\s*<<(.*?)>>", re.DOTALL)
_FONT_NAME_REF_RE = re.compile(rb"/([^\s/<>\[\]()%]+)\s+(\d+)\s+\d+\s+R")

_LITERAL = rb"\((?:\\.|[^\\()])*\)"
_HEX = rb"<[0-9A-Fa-f\s]*>"
_STRING = rb"(?:" + _LITERAL + rb"|" + _HEX + rb")"
# one pass over the content stream, in order: font switches and text shows
_CONTENT_TOKEN_RE = re.compile(
    rb"(?P<tf>/(?P<fname>[^\s/<>\[\]()%]+)\s+[-\d.]+\s+Tf)"
    rb"|(?P<tj>" + _STRING + rb")\s*(?:Tj|'|\")"
    rb"|\[(?P<tjarr>(?:[^\[\]\\]|\\.)*)\]\s*TJ",
    re.DOTALL,
)
_STRING_RE = re.compile(_STRING)

_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\",
}

# ToUnicode CMap sections
_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.DOTALL)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.DOTALL)
_HEX_TOKEN_RE = re.compile(rb"<([0-9A-Fa-f]+)>")
_BFRANGE_ITEM_RE = re.compile(
    rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*(?:<([0-9A-Fa-f]+)>|\[(.*?)\])",
    re.DOTALL,
)


def _string_bytes(raw: bytes) -> bytes:
    """Decode a PDF string token (literal or hex) to its raw byte content."""
    if raw.startswith(b"<"):
        digits = re.sub(rb"\s+", b"", raw[1:-1])
        if len(digits) % 2:
            digits += b"0"  # PDF spec: odd final digit implies trailing 0
        try:
            return bytes.fromhex(digits.decode("ascii"))
        except ValueError:
            return b""
    body = raw[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        ch = body[i : i + 1]
        if ch == b"\\" and i + 1 < len(body):
            nxt = body[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if 0x30 <= body[i + 1] <= 0x37:  # octal escape \d{1,3}
                j = i + 1
                digits = b""
                while j < len(body) and len(digits) < 3 and 0x30 <= body[j] <= 0x37:
                    digits += body[j : j + 1]
                    j += 1
                out.append(int(digits, 8) & 0xFF)
                i = j
                continue
            i += 1  # line continuation or unknown escape: skip backslash
            continue
        out += ch
        i += 1
    return bytes(out)


def _utf16be_to_str(hexdigits: bytes) -> str:
    try:
        return bytes.fromhex(hexdigits.decode("ascii")).decode(
            "utf-16-be", errors="replace"
        )
    except ValueError:
        return ""


class _CMap:
    """code (int) -> unicode string map with the code byte-width."""

    def __init__(self, code_bytes: int) -> None:
        self.code_bytes = code_bytes
        self.map: dict[int, str] = {}

    def decode(self, raw: bytes) -> str:
        w = self.code_bytes
        out = []
        for i in range(0, len(raw) - w + 1, w):
            code = int.from_bytes(raw[i : i + w], "big")
            mapped = self.map.get(code)
            if mapped is not None:
                out.append(mapped)
            elif w == 1:
                out.append(raw[i : i + 1].decode("latin-1"))
            # unmapped multi-byte codes: drop (PdfPig yields U+FFFD/garbage;
            # dropping keeps search text clean)
        return "".join(out)


def _parse_tounicode(stream: bytes) -> dict[int, str]:
    mapping: dict[int, str] = {}
    for section in _BFCHAR_RE.finditer(stream):
        tokens = _HEX_TOKEN_RE.findall(section.group(1))
        for src, dst in zip(tokens[0::2], tokens[1::2]):
            mapping[int(src, 16)] = _utf16be_to_str(dst)
    for section in _BFRANGE_RE.finditer(stream):
        for item in _BFRANGE_ITEM_RE.finditer(section.group(1)):
            lo, hi = int(item.group(1), 16), int(item.group(2), 16)
            if hi - lo > 65535:
                continue  # malformed; bound the work
            if item.group(3) is not None:
                base = item.group(3)
                base_str = _utf16be_to_str(base)
                base_code = int(base, 16)
                for code in range(lo, hi + 1):
                    if len(base_str) == 1:
                        mapping[code] = chr(ord(base_str) + (code - lo))
                    else:  # multi-char target: increment the last UTF-16 unit
                        bumped = f"{base_code + (code - lo):0{len(base)}X}"
                        mapping[code] = _utf16be_to_str(bumped.encode("ascii"))
            else:
                dsts = _HEX_TOKEN_RE.findall(item.group(4) or b"")
                for offset, dst in enumerate(dsts):
                    if lo + offset <= hi:
                        mapping[lo + offset] = _utf16be_to_str(dst)
    return mapping


# Cap per-stream inflation: a deflate bomb in a tiny upload could otherwise
# expand to gigabytes and OOM the server before any except clause runs
# ("malformed input must not crash ingestion"). 64 MiB decompressed per
# stream is far beyond any real text content stream.
_MAX_STREAM_BYTES = 64 * 1024 * 1024


def _decompress(stream: bytes) -> bytes:
    try:
        d = zlib.decompressobj()
        out = d.decompress(stream, _MAX_STREAM_BYTES)
        if d.unconsumed_tail:
            # bomb/oversized: keep the capped prefix, but make the silent
            # truncation of an oversized-but-legitimate stream observable
            logger.warning(
                "PDF content stream exceeded the %d-byte decompression cap; "
                "text beyond the cap is dropped", _MAX_STREAM_BYTES,
            )
        return out
    except zlib.error:
        return stream  # uncompressed or unsupported filter; try as-is


def _build_font_cmaps(data: bytes) -> dict[bytes, _CMap]:
    """Resource font name (e.g. b'F1') -> CMap, resolved via object refs."""
    objects: dict[int, bytes] = {
        int(m.group(1)): m.group(2) for m in _OBJ_RE.finditer(data)
    }
    # font object number -> CMap
    font_cmaps: dict[int, _CMap] = {}
    for num, body in objects.items():
        head = body.split(b"stream", 1)[0]
        if b"/Font" not in head and b"/ToUnicode" not in head:
            continue
        m = _TOUNICODE_RE.search(head)
        if not m:
            continue
        target = objects.get(int(m.group(1)))
        if target is None:
            continue
        sm = _STREAM_RE.search(target)
        if sm is None:
            continue
        mapping = _parse_tounicode(_decompress(sm.group(1)))
        if not mapping:
            continue
        code_bytes = 2 if (b"/Type0" in head or max(mapping) > 0xFF) else 1
        cmap = _CMap(code_bytes)
        cmap.map = mapping
        font_cmaps[num] = cmap
    # resource name -> font object number (any /Font resource dict)
    by_name: dict[bytes, _CMap] = {}
    for res in _FONT_RES_RE.finditer(data):
        for name, ref in _FONT_NAME_REF_RE.findall(res.group(1)):
            if int(ref) in font_cmaps:
                by_name[name] = font_cmaps[int(ref)]
    return by_name


def _extract_stream_text(stream: bytes, fonts: dict[bytes, _CMap]) -> list[str]:
    pieces: list[str] = []
    current: _CMap | None = None
    default = _CMap(1)  # latin-1 passthrough

    def show(raw: bytes) -> None:
        text = (current or default).decode(_string_bytes(raw))
        if text:
            pieces.append(text)

    for match in _CONTENT_TOKEN_RE.finditer(stream):
        if match.group("tf"):
            current = fonts.get(match.group("fname"))
        elif match.group("tj") is not None:
            show(match.group("tj"))
        else:
            parts = []
            for s in _STRING_RE.finditer(match.group("tjarr")):
                parts.append((current or default).decode(_string_bytes(s.group(0))))
            if parts:
                pieces.append("".join(parts))
    return pieces


def extract_pdf_text(data: bytes) -> str:
    if not data.lstrip().startswith(b"%PDF"):
        raise ValueError("Not a PDF document.")
    fonts = _build_font_cmaps(data)
    pieces: list[str] = []
    for match in _STREAM_RE.finditer(data):
        stream = _decompress(match.group(1))
        pieces.extend(_extract_stream_text(stream, fonts))
    return "\n".join(p for p in pieces if p.strip()).strip()


class PdfTextExtractor:
    def __init__(self, ocr_extractor=None, pdf_text_min_chars: int = 120) -> None:
        self.ocr = ocr_extractor or NoOpOcrTextExtractor()
        self.min_chars = pdf_text_min_chars

    def extract_text(self, data: bytes) -> str:
        text = ""
        try:
            text = extract_pdf_text(data)
        except Exception:
            text = ""
        if len(text) >= self.min_chars:
            return text
        try:
            ocr_text = self.ocr.extract_text(data)
        except Exception:
            # the OCR extractor documents a never-raises contract, but a
            # flaky endpoint must still not fail the upload — fall back to
            # whatever the parser produced
            ocr_text = ""
        # Prefer whichever attempt produced content (reference: OCR result is
        # returned when the parsed text is too short, PdfPigTextExtractor.cs:33-40)
        return ocr_text if ocr_text.strip() else text
