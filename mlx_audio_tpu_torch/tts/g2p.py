"""Fallback English grapheme-to-phoneme (G2P) conversion.

The port's own copy of mlx_audio_tpu/tts/g2p.py, kept equal to it (the
port imports nothing of the JAX package); tests/test_torch_imports.py
holds the two to the same output.

Upstream Kokoro delegates G2P to the `misaki` package (espeak-backed for
many languages). `misaki`/`espeak` are optional here; when absent this module provides a
self-contained rule-based American-English G2P producing misaki-style IPA
strings good enough to drive Kokoro-style models offline. When misaki is
installed it is always preferred (see kokoro/pipeline.py).

Output alphabet (misaki en-US subset): consonants b d f h j k l m n p s t v w
z ɡ ŋ ɹ ʃ ʒ ð θ ʤ ʧ; vowels ɑ æ ʌ ɔ ɛ ə ɜ ɪ i ʊ u; diphthongs A I O W Y
(eɪ aɪ oʊ aʊ ɔɪ); stress marks ˈ ˌ.
"""

from __future__ import annotations

import re
from typing import List

# Small lexicon of frequent/irregular words (misaki-style phonemes).
LEXICON = {
    "a": "ə", "an": "ən", "the": "ðə", "of": "ʌv", "to": "tu", "and": "ænd",
    "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "ju", "that": "ðæt",
    "he": "hi", "she": "ʃi", "was": "wʌz", "for": "fɔɹ", "on": "ɑn",
    "are": "ɑɹ", "as": "æz", "with": "wɪð", "his": "hɪz", "her": "hɜɹ",
    "they": "ðA", "i": "I", "at": "æt", "be": "bi", "this": "ðɪs",
    "have": "hæv", "from": "fɹʌm", "or": "ɔɹ", "one": "wʌn", "had": "hæd",
    "by": "bI", "word": "wɜɹd", "but": "bʌt", "not": "nɑt", "what": "wʌt",
    "all": "ɔl", "were": "wɜɹ", "we": "wi", "when": "wɛn", "your": "jɔɹ",
    "can": "kæn", "said": "sɛd", "there": "ðɛɹ", "use": "juz", "each": "iʧ",
    "which": "wɪʧ", "do": "du", "how": "hW", "their": "ðɛɹ", "if": "ɪf",
    "will": "wɪl", "up": "ʌp", "other": "ˈʌðəɹ", "about": "əˈbWt",
    "out": "Wt", "many": "ˈmɛni", "then": "ðɛn", "them": "ðɛm",
    "these": "ðiz", "so": "sO", "some": "sʌm", "would": "wʊd",
    "make": "mAk", "like": "lIk", "him": "hɪm", "into": "ˈɪntu",
    "time": "tIm", "has": "hæz", "look": "lʊk", "two": "tu", "more": "mɔɹ",
    "write": "ɹIt", "go": "ɡO", "see": "si", "no": "nO", "way": "wA",
    "could": "kʊd", "my": "mI", "than": "ðæn", "first": "fɜɹst",
    "water": "ˈwɔtəɹ", "been": "bɪn", "who": "hu", "its": "ɪts",
    "now": "nW", "people": "ˈpipəl", "over": "ˈOvəɹ", "did": "dɪd",
    "down": "dWn", "only": "ˈOnli", "way": "wA", "find": "fInd",
    "long": "lɔŋ", "day": "dA", "get": "ɡɛt", "come": "kʌm",
    "made": "mAd", "may": "mA", "part": "pɑɹt", "hello": "həˈlO",
    "world": "wɜɹld", "speech": "spiʧ", "voice": "vɔɪs", "text": "tɛkst",
    "audio": "ˈɔdiO", "model": "ˈmɑdəl", "test": "tɛst", "good": "ɡʊd",
    "very": "ˈvɛɹi", "here": "hiɹ", "where": "wɛɹ", "why": "wI",
    "because": "bɪˈkʌz", "through": "θɹu", "does": "dʌz", "should": "ʃʊd",
    "our": "Wɹ", "right": "ɹIt", "new": "nu", "sound": "sWnd",
    "any": "ˈɛni", "work": "wɜɹk", "three": "θɹi", "years": "jiɹz",
    "also": "ˈɔlsO", "know": "nO", "name": "nAm", "say": "sA",
    "great": "ɡɹAt", "think": "θɪŋk", "help": "hɛlp", "low": "lO",
    "line": "lIn", "before": "bɪˈfɔɹ", "too": "tu", "mean": "min",
    "same": "sAm", "tell": "tɛl", "boy": "bY", "follow": "ˈfɑlO",
    "came": "kAm", "want": "wɑnt", "show": "ʃO", "around": "əˈɹWnd",
    "once": "wʌns", "five": "fIv", "give": "ɡɪv", "most": "mOst",
    "quick": "kwɪk", "brown": "bɹWn", "fox": "fɑks", "jumps": "ʤʌmps",
    "lazy": "ˈlAzi", "dog": "dɔɡ", "today": "təˈdA", "machine": "məˈʃin",
    "learning": "ˈlɜɹnɪŋ", "language": "ˈlæŋɡwɪʤ", "synthesis": "ˈsɪnθəsɪs",
    "quality": "ˈkwɑlɪti", "framework": "ˈfɹAmwɜɹk",
}

_DIGITS = {
    "0": "ˈziɹO", "1": "wʌn", "2": "tu", "3": "θɹi", "4": "fɔɹ",
    "5": "fIv", "6": "sɪks", "7": "ˈsɛvən", "8": "At", "9": "nIn",
}

# Spoken-number vocabulary emitted by textnorm (numbers, ordinals,
# magnitudes, currency/unit words) — pronounced precisely rather than
# through the letter-to-sound fallback.
LEXICON.update({
    "zero": "ˈziɹO", "four": "fɔɹ", "six": "sɪks", "seven": "ˈsɛvən",
    "eight": "At", "nine": "nIn", "ten": "tɛn", "eleven": "ɪˈlɛvən",
    "twelve": "twɛlv", "thirteen": "θɜɹˈtin", "fourteen": "fɔɹˈtin",
    "fifteen": "fɪfˈtin", "sixteen": "sɪksˈtin",
    "seventeen": "sɛvənˈtin", "eighteen": "Aˈtin",
    "nineteen": "nInˈtin", "twenty": "ˈtwɛnti", "thirty": "ˈθɜɹti",
    "forty": "ˈfɔɹti", "fifty": "ˈfɪfti", "sixty": "ˈsɪksti",
    "seventy": "ˈsɛvənti", "eighty": "ˈAti", "ninety": "ˈnInti",
    "hundred": "ˈhʌndɹəd", "thousand": "ˈθWzənd",
    "million": "ˈmɪljən", "billion": "ˈbɪljən", "trillion": "ˈtɹɪljən",
    "percent": "pəɹˈsɛnt", "point": "pɔɪnt", "negative": "ˈnɛɡətɪv",
    "dollar": "ˈdɑləɹ", "dollars": "ˈdɑləɹz", "euro": "ˈjʊɹO",
    "euros": "ˈjʊɹOz", "pound": "pWnd", "pounds": "pWndz",
    "cent": "sɛnt", "cents": "sɛnts", "second": "ˈsɛkənd",
    "third": "θɜɹd", "fifth": "fɪfθ", "ninth": "nInθ",
    "half": "hæf", "halves": "hævz", "quarter": "ˈkwɔɹtəɹ",
    "quarters": "ˈkwɔɹtəɹz", "oh": "O", "dot": "dɑt",
})

# Ordered letter-to-sound rules: (pattern, phonemes). Longest-match-first.
_LTS = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ough", "O"), ("augh", "ɔ"),
    ("eigh", "A"), ("igh", "I"), ("tch", "ʧ"), ("dge", "ʤ"),
    ("sch", "sk"), ("ing", "ɪŋ"), ("ear", "iɹ"), ("our", "ɔɹ"),
    ("ck", "k"), ("ch", "ʧ"), ("sh", "ʃ"), ("th", "θ"), ("ph", "f"),
    ("wh", "w"), ("qu", "kw"), ("ng", "ŋ"), ("gh", "ɡ"), ("kn", "n"),
    ("wr", "ɹ"), ("ee", "i"), ("ea", "i"), ("oo", "u"), ("ou", "W"),
    ("ow", "O"), ("ai", "A"), ("ay", "A"), ("oi", "Y"), ("oy", "Y"),
    ("au", "ɔ"), ("aw", "ɔ"), ("ar", "ɑɹ"), ("er", "əɹ"), ("ir", "ɜɹ"),
    ("or", "ɔɹ"), ("ur", "ɜɹ"), ("oa", "O"), ("ie", "i"), ("ei", "A"),
    ("ue", "u"), ("ew", "u"),
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"),
    ("f", "f"), ("g", "ɡ"), ("h", "h"), ("i", "ɪ"), ("j", "ʤ"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("o", "ɑ"),
    ("p", "p"), ("r", "ɹ"), ("s", "s"), ("t", "t"), ("u", "ʌ"),
    ("v", "v"), ("w", "w"), ("x", "ks"), ("y", "j"), ("z", "z"),
]


def _lts_word(word: str) -> str:
    """Naive longest-match letter-to-sound for out-of-lexicon words."""
    out = []
    i = 0
    n = len(word)
    while i < n:
        # magic-e: consonant + vowel + consonant + final e
        if (i + 2 < n and word[i] in "aeiou" and word[i + 1] not in "aeiou"
                and i + 2 == n - 1 and word[i + 2] == "e"):
            long_v = {"a": "A", "e": "i", "i": "I", "o": "O", "u": "u"}
            out.append(long_v.get(word[i], word[i]))
            out.append(dict(_LTS).get(word[i + 1], ""))
            i += 3
            continue
        for pat, ph in _LTS:
            if word.startswith(pat, i):
                # soft c/g before front vowels
                if pat == "c" and i + 1 < n and word[i + 1] in "eiy":
                    ph = "s"
                if pat == "g" and i + 1 < n and word[i + 1] in "eiy":
                    ph = "ʤ"
                out.append(ph)
                i += len(pat)
                break
        else:
            i += 1  # drop unknown char
    return "".join(out)


def word_to_phonemes(word: str) -> str:
    w = word.lower()
    if w in LEXICON:
        return LEXICON[w]
    if w.isdigit():
        return " ".join(_DIGITS[c] for c in w)
    # simple plural / -ed handling via lexicon stems
    if w.endswith("s") and w[:-1] in LEXICON:
        return LEXICON[w[:-1]] + "z"
    if w.endswith("ed") and w[:-2] in LEXICON:
        return LEXICON[w[:-2]] + "d"
    return _lts_word(w)


def g2p(text: str) -> str:
    """English text -> misaki-style phoneme string with punctuation kept.

    Numeric/spoken-form expansion (numbers, currency, time, units,
    ordinals... — reference kitten_tts/preprocess.py behaviours) runs
    first via `textnorm.normalize_for_g2p`, so "1200" reads "twelve
    hundred" rather than digit-by-digit."""
    from .textnorm import normalize_for_g2p

    text = normalize_for_g2p(text)
    tokens = re.findall(r"[A-Za-z]+|\d+|[^\sA-Za-z\d]", text)
    parts: List[str] = []
    for tok in tokens:
        if re.fullmatch(r"[A-Za-z]+|\d+", tok):
            parts.append(word_to_phonemes(tok))
        else:
            # punctuation passes through (Kokoro vocab includes it)
            if parts:
                parts[-1] = parts[-1] + tok
            else:
                parts.append(tok)
    return " ".join(parts)
