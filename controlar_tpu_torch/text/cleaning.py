"""Caption cleaning: the port's copy of the JAX package's `text/cleaning.py`.

The t2i pipeline cleans captions twice before tokenization (the public
PixArt / DeepFloyd-IF recipe); FID and CLIP comparisons assume identical
prompts, so the rules are an ordered table kept as the JAX package has it.

One change: the JAX package strips markup with BeautifulSoup's
"html.parser" builder, and the card's machine has no bs4. `html_text` runs
the standard library's `html.parser.HTMLParser` with the callbacks that
builder installs and keeps the strings `.text` keeps, so it returns the
same string (the tests hold it to bs4 on the CPU).

ftfy is optional, as in the JAX package: without it `basic_clean` only
unescapes HTML twice (ftfy's mojibake repair rarely triggers on ASCII
captions). It is imported when first needed, so importing this module
loads neither ftfy nor bs4.
"""
from __future__ import annotations

import html
import re
import urllib.parse as ul
from html.entities import html5
from html.parser import HTMLParser

# bs4's named entities: html5's names without their ';', the first of each
# name in sorted order
_ENTITIES: dict = {}
for _name, _char in sorted(html5.items()):
    _ENTITIES.setdefault(_name[:-1] if _name.endswith(";") else _name, _char)
# string containers whose text `.text` leaves out, and the tags that keep
# whitespace-only strings as they are
_HIDDEN = ("rt", "rp", "style", "script", "template")
_PRESERVE = ("pre", "textarea")
# tags bs4 closes as soon as they open
_VOID = frozenset(("area", "base", "br", "col", "embed", "hr", "img", "input", "keygen",
                   "link", "menuitem", "meta", "param", "source", "track", "wbr",
                   "basefont", "bgsound", "command", "frame", "image", "isindex", "nextid",
                   "spacer"))


def _numeric_reference(name: str):
    """bs4's numeric character reference: (text, text after the number)."""
    base, digits = (16, "[0-9a-f]") if name[:1] in "xX" else (10, "[0-9]")
    if base == 16:
        name = name[1:]
    m = re.match(f"^({digits}+)(.*)", name)
    try:
        n, extra = int(name, base), ""
    except ValueError:
        if m is None:
            return "", name
        n, extra = int(m.group(1), base), m.group(2)
    if n == 0 or n > 0x10FFFF or 0xD800 <= n <= 0xDFFF:
        return "\ufffd", extra
    if 0x80 <= n <= 0x9F and n not in (0x81, 0x8D, 0x8F, 0x90, 0x9D):
        return bytes([n]).decode("cp1252"), extra
    return chr(n), extra


class _Text(HTMLParser):
    """The strings of BeautifulSoup(markup, "html.parser").text: the events
    bs4's builder handles (its tag stack, its entity rules, a whitespace-only
    string made one space or newline), the text of rt / rp / style / script /
    template, comments, declarations and processing instructions dropped,
    CDATA kept."""

    def __init__(self):
        super().__init__(convert_charrefs=False)
        self.out, self.data, self.stack, self.closed = [], [], [], []

    def flush(self, kind: str = "text") -> None:
        """End a string: "text" is kept outside the hidden containers,
        "cdata" anywhere, "dropped" nowhere."""
        if not self.data:
            return
        s, self.data = "".join(self.data), []
        if not any(t in _PRESERVE for t in self.stack) and all(ch in " \n\t\x0c\r" for ch in s):
            s = "\n" if "\n" in s else " "
        hidden = any(t in _HIDDEN for t in self.stack)
        if kind == "cdata" or (kind == "text" and not hidden):
            self.out.append(s)

    def handle_data(self, data):
        self.data.append(data)

    def handle_entityref(self, name):
        self.data.append(_ENTITIES.get(name, "&" + name))

    def handle_charref(self, name):
        text, extra = _numeric_reference(name)
        self.data.extend(s for s in (text, extra) if s)

    def handle_starttag(self, tag, attrs, empty: bool = True):
        self.flush()
        self.stack.append(tag)
        if empty and tag in _VOID:
            self.handle_endtag(tag, check_closed=False)
            self.closed.append(tag)

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs, empty=False)
        self.handle_endtag(tag, check_closed=False)

    def handle_endtag(self, tag, check_closed: bool = True):
        if check_closed and tag in self.closed:
            self.closed.remove(tag)
            return
        self.flush()
        if tag in self.stack:
            while self.stack.pop() != tag:
                pass

    def _dropped(self, data):
        self.flush()
        self.data.append(data)
        self.flush("dropped")

    handle_comment = handle_decl = handle_pi = _dropped

    def unknown_decl(self, data):
        if not data.upper().startswith("CDATA["):
            return self._dropped(data)
        self.flush()
        self.data.append(data[len("CDATA["):])
        self.flush("cdata")


def html_text(markup: str) -> str:
    """BeautifulSoup(markup, features="html.parser").text without bs4."""
    p = _Text()
    p.feed(markup)
    p.close()
    p.flush()
    return "".join(p.out)


# ref t5.py:29-33 (bad_punct_regex)
BAD_PUNCT = re.compile(
    r"["
    + "#®•©™&@·º½¾¿¡§~"
    + r"\)"
    + r"\("
    + r"\]"
    + r"\["
    + r"\}"
    + r"\{"
    + r"\|"
    + "\\\\"
    + r"\/"
    + r"\*"
    + r"]{1,}"
)

_DASHES = (
    r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B"
    r"\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+"
)
_URL1 = (
    r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]"
    r"(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))"
)
_URL2 = (
    r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.]"
    r"(?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))"
)


def basic_clean(text: str) -> str:
    try:  # optional mojibake repair, imported on first use
        import ftfy
    except ImportError:
        pass
    else:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def clean_caption(caption: str) -> str:
    """One cleaning pass (ref t5.py:95-201). Apply twice via text_preprocess."""
    c = str(caption)
    c = ul.unquote_plus(c)
    c = c.strip().lower()
    c = re.sub("<person>", "person", c)
    c = re.sub(_URL1, "", c)
    c = re.sub(_URL2, "", c)
    c = html_text(c)
    c = re.sub(r"@[\w\d]+\b", "", c)
    # CJK blocks
    for rng in (
        r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
        r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
        r"[\u4e00-\u9fff]+",
    ):
        c = re.sub(rng, "", c)
    c = re.sub(_DASHES, "-", c)
    c = re.sub(r"[`´«»“”¨]", '"', c)
    c = re.sub(r"[‘’]", "'", c)
    c = re.sub(r"&quot;?", "", c)
    c = re.sub(r"&amp", "", c)
    c = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", c)  # IPs
    c = re.sub(r"\d:\d\d\s+$", "", c)  # article ids
    c = re.sub(r"\\n", " ", c)
    c = re.sub(r"#\d{1,3}\b", "", c)
    c = re.sub(r"#\d{5,}\b", "", c)
    c = re.sub(r"\b\d{6,}\b", "", c)
    c = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "", c)
    c = re.sub(r"[\"\']{2,}", r'"', c)
    c = re.sub(r"[\.]{2,}", r" ", c)
    c = re.sub(BAD_PUNCT, r" ", c)
    c = re.sub(r"\s+\.\s+", r" ", c)
    regex2 = re.compile(r"(?:\-|\_)")
    if len(re.findall(regex2, c)) > 3:
        c = re.sub(regex2, " ", c)
    c = basic_clean(c)
    c = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", c)
    c = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", c)
    c = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", c)
    c = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", c)
    c = re.sub(r"(free\s)?download(\sfree)?", "", c)
    c = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", c)
    c = re.sub(r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "", c)
    c = re.sub(r"\bpage\s+\d+\b", "", c)
    c = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ", c)
    c = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", c)
    c = re.sub(r"\b\s+\:\s+", r": ", c)
    c = re.sub(r"(\D[,\./])\b", r"\1 ", c)
    c = re.sub(r"\s+", " ", c)
    c.strip()  # no-op, preserved from the reference for fidelity
    c = re.sub(r'^[\"\']([\w\W]+)[\"\']$', r"\1", c)
    c = re.sub(r"^[\'\_,\-\:;]", r"", c)
    c = re.sub(r"[\'\_,\-\:\-\+]$", r"", c)
    c = re.sub(r"^\.\S+$", "", c)
    return c.strip()


def text_preprocess(text: str, use_cleaning: bool = True) -> str:
    """(ref t5.py:80-87: clean twice; else lower/strip.)"""
    if use_cleaning:
        return clean_caption(clean_caption(text))
    return text.lower().strip()
