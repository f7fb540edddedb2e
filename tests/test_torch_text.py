"""The port's caption cleaning against the JAX package's, on the CPU (where
bs4 is installed): `text_preprocess` must return the same string, and the
port's markup stripper (the standard library's HTMLParser with bs4's
html.parser callbacks) the same text as `BeautifulSoup(s, "html.parser")
.text`. Tolerance: none, the strings are equal."""
import random

import pytest
from bs4 import BeautifulSoup

from controlar_tpu.text import cleaning as jclean
from controlar_tpu_torch.text import cleaning as tclean

CAPTIONS = [
    "A photo of a cat sitting on a mat.",
    "  Two dogs playing in the SNOW  ",
    "a <b>bold</b> move in <i>italics</i>",
    "x<y and y>z",
    "1 < 2 and 3 > 2",
    "fish &amp; chips &amp; peas",
    "caf&eacute; latte&nbsp;art",
    "&quot;quoted&quot; words and &#39;single&#39; ones",
    "at&t store, r&b music, black&white photo",
    "<script>alert('x')</script>safe text",
    "<style>p {color: red}</style>styled",
    "before<!-- a comment -->after",
    "<p>one<p>two<br/>three<br>four</br>",
    "<pre>  kept   spaces  </pre> and <b>  </b> spaces",
    "visit https://example.com/path?q=1 for more",
    "www.example.org has photos of boats",
    "shop at mysite.com/sale now, free shipping worldwide",
    "中文 字幕 a chinese caption 漢字",
    "emoji 😀 and 🐈 cats",
    "ｆｕｌｌｗｉｄｔｈ letters and ー dashes ‐ – —",
    "«guillemets» and “curly” ‘quotes’",
    "image_12345.jpg on page 3 of the article",
    "ip 192.168.0.1 address and #123 tag #123456 id",
    "a 1920x1080 wallpaper, 4k hd",
    "abc123def and a1b2c3 codes",
    "@user mentioned this in a tweet",
    "<person> walking a dog",
    "click for details, download free",
    "some_snake_case_words-with-many-dashes-here",
    "'a quoted caption'",
    "...leading dots and trailing dots...",
    "percent%20encoded%20caption+with+pluses",
    "unclosed <b tag at the end",
    "<![CDATA[raw data]]> after cdata",
    "<!doctype html><html><body>page body</body></html>",
    "tabs\tand\nnewlines\\n literal",
    "<template>hidden</template>shown <ruby>kan<rt>k</rt></ruby>",
    "&#150; windows dash &#x2014; em dash &#0; null",
    "",
    "   ",
]


@pytest.mark.parametrize("i", range(len(CAPTIONS)))
def test_text_preprocess_matches_jax(i):
    c = CAPTIONS[i]
    assert tclean.text_preprocess(c) == jclean.text_preprocess(c)
    assert tclean.clean_caption(c) == jclean.clean_caption(c)
    assert tclean.text_preprocess(c, use_cleaning=False) == jclean.text_preprocess(
        c, use_cleaning=False)


# the cases the markup stripper must keep: a tag, a bare '<', hidden script /
# style text, comments, an entity, a self-closed tag between spaces
HTML_CASES = {
    "x<y and y>z": "xz",
    "1 < 2": "1 < 2",
    "a<script>var x = 1;</script>b<style>p{}</style>c": "abc",
    "a<!-- c -->b": "ab",
    "&nbsp;": "\xa0",
    "a <br/> b": "a  b",
}


@pytest.mark.parametrize("markup", list(HTML_CASES))
def test_html_text_cases(markup):
    assert tclean.html_text(markup) == HTML_CASES[markup]
    assert BeautifulSoup(markup, features="html.parser").text == HTML_CASES[markup]


_FRAGMENTS = [
    "<b>", "</b>", "<br>", "</br>", "<br/>", "<script>", "</script>", "<style>", "</style>",
    "<template>", "</template>", "<rt>", "</rt>", "<pre>", "</pre>", "<textarea>",
    "</textarea>", "<!-- c -->", "<!--", "-->", "<!doctype html>", "<?pi x?>",
    "<![CDATA[cd]]>", "<![if x]>", "&amp;", "&amp", "&nbsp;", "&notit;", "&t", "&#39;",
    "&#x27;", "&#0;", "&#150;", "&#129;", "&#xD800;", "&#12a;", "&#x;", "&", "<", ">", "x<y",
    " ", "  ", "\n", " \n ", "a", "hello", "1 < 2", "<img src=x>", '<p class="a b">', "</p>",
    '<a href="http://x.com">', "</a>", "é", "中文", "😀", "\t", "</", "<1>", "< b>", "<!>",
    "</ >", "<title>", "</title>", "<ruby>", "<rp>", "</rp>", "<div\n>", "<x y='<z>'>",
]


@pytest.mark.parametrize("seed", range(4))
def test_html_text_matches_bs4_on_random_markup(seed):
    rng = random.Random(seed)
    for _ in range(1500):
        s = "".join(rng.choice(_FRAGMENTS) for _ in range(rng.randint(1, 12)))
        assert tclean.html_text(s) == BeautifulSoup(s, features="html.parser").text, s


def test_basic_clean_matches_jax():
    for s in ("  &amp;amp; double  ", "plain", "&lt;tag&gt;"):
        assert tclean.basic_clean(s) == jclean.basic_clean(s)
