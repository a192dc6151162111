"""Whisper tokenizer: HF files when present, convention-based specials always.

The port's own copy of mlx_audio_tpu/stt/models/whisper/tokenizer.py, kept
equal to it (the port imports nothing of the JAX package). Special-token ids
follow the fixed OpenAI layout derived from n_vocab, so the decoding rules
(timestamps, suppression) work without tokenizer files: the "dummy" mode,
which a machine without `transformers` always takes. The optional HF mode
is guarded exactly as in the JAX package.
"""

from __future__ import annotations

from functools import cached_property, lru_cache
from pathlib import Path
from typing import List, Optional, Tuple

LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}


class WhisperTokenizer:
    """Byte-pair tokenizer facade with whisper special-token layout.

    Modes:
      * "hf": transformers tokenizer loaded from the model dir (real use)
      * "dummy": id<->"<id>" passthrough (tiny-config tests, no files needed)
    """

    def __init__(self, n_vocab: int, model_path: Optional[str] = None,
                 language: str = "en", task: str = "transcribe"):
        self.n_vocab = n_vocab
        self.language = language or "en"
        self.task = task
        self._hf = None
        if model_path is not None:
            try:
                from transformers import AutoTokenizer

                if (Path(model_path) / "tokenizer.json").exists() or (
                        Path(model_path) / "vocab.json").exists():
                    self._hf = AutoTokenizer.from_pretrained(str(model_path))
            except Exception:
                self._hf = None

        # --- fixed OpenAI layout ---
        self.multilingual = n_vocab >= 51865
        if self.multilingual:
            self.num_languages = 100 if n_vocab >= 51866 else 99
            self._eot = 50257
        else:
            self.num_languages = 99
            self._eot = 50256
        self._sot = self._eot + 1
        self._lang_base = self._sot + 1
        self._translate = self._lang_base + self.num_languages
        self._transcribe = self._translate + 1
        self._sot_lm = self._transcribe + 1
        self._sot_prev = self._sot_lm + 1
        self._no_speech = self._sot_prev + 1
        self._no_timestamps = self._no_speech + 1
        self._timestamp_begin = self._no_timestamps + 1

    # -- special tokens ----------------------------------------------------

    @property
    def eot(self) -> int:
        return self._eot

    @property
    def sot(self) -> int:
        return self._sot

    @property
    def sot_lm(self) -> int:
        return self._sot_lm

    @property
    def sot_prev(self) -> int:
        return self._sot_prev

    @property
    def no_speech(self) -> int:
        return self._no_speech

    @property
    def no_timestamps(self) -> int:
        return self._no_timestamps

    @property
    def timestamp_begin(self) -> int:
        return self._timestamp_begin

    @property
    def transcribe(self) -> int:
        return self._transcribe

    @property
    def translate(self) -> int:
        return self._translate

    def language_token_of(self, lang: str) -> int:
        codes = list(LANGUAGES.keys())[: self.num_languages]
        if lang not in codes:
            raise KeyError(f"Unknown language: {lang}")
        return self._lang_base + codes.index(lang)

    @property
    def language_token(self) -> int:
        return self.language_token_of(self.language)

    @property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self._lang_base + i for i in range(self.num_languages))

    @property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(list(LANGUAGES.keys())[: self.num_languages])

    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        if not self.multilingual:
            return (self.sot,)
        task_tok = self.transcribe if self.task == "transcribe" else self.translate
        return (self.sot, self.language_token, task_tok)

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(self.sot_sequence) + (self.no_timestamps,)

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Symbols/music tokens to suppress (reference whisper.py:165-183)."""
        if self._hf is None:
            return ()
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ "
            "♪♪♪".split())
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return tuple(sorted(result))

    # -- encode / decode ---------------------------------------------------

    def encode(self, text: str) -> List[int]:
        if self._hf is not None:
            return self._hf.encode(text, add_special_tokens=False)
        # dummy fallback: char codes (test mode only)
        return [min(ord(c), self._eot - 1) for c in text]

    def decode(self, tokens, skip_special_tokens: bool = True) -> str:
        tokens = [int(t) for t in tokens]
        if skip_special_tokens:
            tokens = [t for t in tokens if t < self._eot]
        if self._hf is not None:
            return self._hf.decode(tokens)
        return "".join(chr(t) if t < 1000 else f"<{t}>" for t in tokens)

    def decode_with_timestamps(self, tokens) -> str:
        out = []
        chunk: List[int] = []
        for t in tokens:
            t = int(t)
            if t >= self.timestamp_begin:
                out.append(self.decode(chunk))
                chunk = []
                out.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                chunk.append(t)
        out.append(self.decode(chunk))
        return "".join(out)

    def split_to_word_tokens(self, tokens: List[int]):
        """Split token list into word strings + their token groups."""
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self._split_tokens_on_unicode(tokens)
        return self._split_tokens_on_spaces(tokens)

    def _split_tokens_on_unicode(self, tokens: List[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "�"
        words, word_tokens = [], []
        cur: List[int] = []
        unicode_offset = 0
        for token in tokens:
            cur.append(int(token))
            decoded = self.decode_with_timestamps(cur)
            if replacement not in decoded or decoded_full[
                unicode_offset + decoded.index(replacement)
            ] == replacement:
                words.append(decoded)
                word_tokens.append(cur)
                cur = []
                unicode_offset += len(decoded)
        return words, word_tokens

    def _split_tokens_on_spaces(self, tokens: List[int]):
        subwords, subword_tokens_list = self._split_tokens_on_unicode(tokens)
        words, word_tokens = [], []
        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] = words[-1] + subword
                word_tokens[-1].extend(subword_tokens)
        return words, word_tokens


@lru_cache(maxsize=8)
def get_tokenizer(n_vocab: int, model_path: Optional[str], language: str,
                  task: str) -> WhisperTokenizer:
    return WhisperTokenizer(n_vocab, model_path, language, task)
