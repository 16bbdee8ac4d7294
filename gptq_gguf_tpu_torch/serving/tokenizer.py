"""GGUF-native tokenizer: encode/decode from tokenizer.ggml.* metadata.

A copy of ``gptq_gguf_tpu/serving/tokenizer.py`` (pure Python; ``jinja2``
is imported only to render chat templates). llama.cpp ships a vocab engine
(llama-vocab.cpp) so a single .gguf file is servable without the HF
tokenizer files; this is its equivalent for the serving engine:

- ``gpt2``  -> byte-level BPE over merge ranks (llm_tokenizer_bpe)
- ``llama`` -> SentencePiece-style greedy score merges with byte fallback
  (llm_tokenizer_spm)
- ``t5``    -> Unigram Viterbi over piece scores (llm_tokenizer_ugm)
- ``bert``  -> WordPiece greedy longest-match over the phantom-space vocab
  (llm_tokenizer_wpm)

Only the default GPT-2 pretokenizer split is implemented (the ``pre`` tag
selects regex variants upstream; they differ mainly on digit grouping).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

__all__ = ["GGUFTokenizer", "from_gguf"]


def _raise_exception(msg):
    raise ValueError(msg)

# GGUF token types (== sentencepiece piece types)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6

# GPT-2 pretokenizer (llama.cpp's default BPE split regex)
_GPT2_PRE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte<->unicode table (transformers bytes_to_unicode)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


class GGUFTokenizer:
    def __init__(self, model: str, tokens: Sequence[str],
                 scores: Optional[Sequence[float]] = None,
                 token_types: Optional[Sequence[int]] = None,
                 merges: Optional[Sequence[str]] = None,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None,
                 unk_id: Optional[int] = None,
                 add_bos: Optional[bool] = None,
                 add_space_prefix: bool = True,
                 chat_template: Optional[str] = None):
        self.model = model
        self.tokens = list(tokens)
        self.scores = list(scores) if scores is not None else None
        self.token_types = (list(token_types) if token_types is not None
                            else [_NORMAL] * len(self.tokens))
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self.merge_ranks = {}
        for rank, m in enumerate(merges or []):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank
        self.bos_id = bos_id
        self.eos_id = eos_id
        if unk_id is None and _UNKNOWN in self.token_types:
            unk_id = self.token_types.index(_UNKNOWN)
        if unk_id is None and "[UNK]" in self.vocab:
            unk_id = self.vocab["[UNK]"]
        self.unk_id = unk_id
        if add_bos is None:
            add_bos = model == "llama" and bos_id is not None
        self.add_bos = add_bos and bos_id is not None
        self.add_space_prefix = add_space_prefix
        self.chat_template = chat_template
        # user-defined/control tokens split the raw text before tokenizing
        self._special = sorted(
            (t for t, i in self.vocab.items()
             if self.token_types[i] in (_CONTROL, _USER_DEFINED) and t),
            key=len, reverse=True)
        self._special_re = (
            re.compile("|".join(re.escape(t) for t in self._special))
            if self._special else None)
        self._byte_ids = {}
        for i, t in enumerate(self.tokens):
            if self.token_types[i] == _BYTE and re.fullmatch(
                    r"<0x[0-9A-Fa-f]{2}>", t):
                self._byte_ids[int(t[3:5], 16)] = i

    # -- encode ---------------------------------------------------------

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids: List[int] = []
        if add_bos if add_bos is not None else self.add_bos:
            ids.append(self.bos_id)
        first = True
        for is_special, chunk in self._split_specials(text):
            if is_special:
                ids.append(self.vocab[chunk])
            elif chunk:
                ids.extend(self._encode_chunk(chunk, first))
            first = False
        return ids

    def _split_specials(self, text: str):
        if self._special_re is None:
            yield (False, text)
            return
        pos = 0
        for m in self._special_re.finditer(text):
            if m.start() > pos:
                yield (False, text[pos:m.start()])
            yield (True, m.group(0))
            pos = m.end()
        if pos < len(text):
            yield (False, text[pos:])

    def _encode_chunk(self, text: str, first: bool) -> List[int]:
        if self.model == "gpt2":
            return self._encode_bpe(text)
        if self.model == "llama":
            return self._encode_spm(text, first)
        if self.model == "t5":
            return self._encode_ugm(text, first)
        if self.model == "bert":
            return self._encode_wpm(text)
        raise NotImplementedError(f"tokenizer model {self.model!r}")

    def _bpe_merge(self, parts: List[str]) -> List[str]:
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts = (parts[:best] + [parts[best] + parts[best + 1]]
                     + parts[best + 2:])
        return parts

    def _encode_bpe(self, text: str) -> List[int]:
        out: List[int] = []
        for m in _GPT2_PRE.finditer(text):
            word = "".join(_BYTE_ENC[b] for b in m.group(0).encode("utf-8"))
            for piece in self._bpe_merge(list(word)):
                i = self.vocab.get(piece)
                if i is not None:
                    out.append(i)
                else:  # unmergeable bytes fall back one char at a time
                    out.extend(self.vocab[c] for c in piece
                               if c in self.vocab)
        return out

    def _encode_spm(self, text: str, first: bool) -> List[int]:
        if first and self.add_space_prefix and not text.startswith(" "):
            text = " " + text
        sym = text.replace(" ", "▁")
        parts = list(sym)
        # greedy highest-score merge of adjacent symbols (llm_tokenizer_spm)
        while len(parts) > 1:
            best, best_score = None, None
            for i in range(len(parts) - 1):
                j = self.vocab.get(parts[i] + parts[i + 1])
                if j is None:
                    continue
                s = self.scores[j] if self.scores else 0.0
                if best_score is None or s > best_score:
                    best, best_score = i, s
            if best is None:
                break
            parts = (parts[:best] + [parts[best] + parts[best + 1]]
                     + parts[best + 2:])
        out: List[int] = []
        for p in parts:
            i = self.vocab.get(p)
            if i is not None and self.token_types[i] != _UNUSED:
                out.append(i)
            else:  # byte fallback
                for b in p.encode("utf-8"):
                    if b in self._byte_ids:
                        out.append(self._byte_ids[b])
        return out

    def _encode_ugm(self, text: str, first: bool) -> List[int]:
        if first and self.add_space_prefix and not text.startswith(" "):
            text = " " + text
        sym = text.replace(" ", "▁")
        n = len(sym)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = -10.0
        for i in range(n):
            if best[i] == NEG:
                continue
            for j in range(i + 1, n + 1):
                piece = sym[i:j]
                k = self.vocab.get(piece)
                if k is not None and self.token_types[k] != _UNUSED:
                    s = best[i] + (self.scores[k] if self.scores else 0.0)
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, k)
            # unknown single char fallback
            if best[i + 1] < best[i] + unk_penalty:
                best[i + 1] = best[i] + unk_penalty
                back[i + 1] = (i, None)
        out: List[int] = []
        j = n
        rev: List[Optional[int]] = []
        while j > 0:
            i, k = back[j]
            rev.append(k)
            j = i
        unk = self.unk_id
        for k in reversed(rev):
            out.append(k if k is not None else unk)
        return [k for k in out if k is not None]

    def _encode_wpm(self, text: str) -> List[int]:
        out: List[int] = []
        unk = self.unk_id
        for word in text.split():
            sym = "▁" + word.lower()
            i = 0
            word_ids: List[int] = []
            ok = True
            while i < len(sym):
                j = len(sym)
                found = None
                while j > i:
                    k = self.vocab.get(sym[i:j])
                    if k is not None:
                        found = k
                        break
                    j -= 1
                if found is None:
                    ok = False
                    break
                word_ids.append(found)
                i = j
            if ok:
                out.extend(word_ids)
            elif unk is not None:
                out.append(unk)
        return out

    def apply_chat_template(self, messages, add_generation_prompt: bool = True,
                            tokenize: bool = False) -> str:
        """Render tokenizer.chat_template over [{role, content}, ...]
        (llama.cpp's minja equivalent, via jinja2)."""
        if not self.chat_template:
            raise ValueError("this GGUF carries no tokenizer.chat_template")
        if tokenize:
            return self.encode(self.apply_chat_template(
                messages, add_generation_prompt))
        import jinja2

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = _raise_exception
        env.filters["tojson"] = lambda x, **kw: __import__("json").dumps(x, **kw)
        bos = self.tokens[self.bos_id] if self.bos_id is not None else ""
        eos = self.tokens[self.eos_id] if self.eos_id is not None else ""
        return env.from_string(self.chat_template).render(
            messages=messages, add_generation_prompt=add_generation_prompt,
            bos_token=bos, eos_token=eos)

    # -- decode ---------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        parts: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                parts.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if i < 0 or i >= len(self.tokens):
                continue
            tt = self.token_types[i]
            if tt in (_CONTROL, _UNKNOWN) and skip_special:
                continue
            t = self.tokens[i]
            if tt == _BYTE:
                byte_buf.extend(bytes([int(t[3:5], 16)]))
                continue
            if self.model == "gpt2":
                # multi-byte UTF-8 sequences may span tokens: keep buffering
                byte_buf.extend(bytes(_BYTE_DEC.get(c, ord(" ")) for c in t))
            else:
                flush()
                parts.append(t.replace("▁", " "))
        flush()
        text = "".join(parts)
        if self.model == "bert":
            text = text.strip()
        return text


def from_gguf(reader) -> Optional[GGUFTokenizer]:
    """Build a GGUFTokenizer from a GGUFReader's metadata; None when the
    file carries no vocab."""
    tokens = reader.get("tokenizer.ggml.tokens")
    if not tokens:
        return None
    model = reader.get("tokenizer.ggml.model", "gpt2")
    return GGUFTokenizer(
        model=model,
        tokens=tokens,
        scores=reader.get("tokenizer.ggml.scores"),
        token_types=reader.get("tokenizer.ggml.token_type"),
        merges=reader.get("tokenizer.ggml.merges"),
        bos_id=reader.get("tokenizer.ggml.bos_token_id"),
        eos_id=reader.get("tokenizer.ggml.eos_token_id"),
        unk_id=reader.get("tokenizer.ggml.unknown_token_id"),
        add_bos=reader.get("tokenizer.ggml.add_bos_token"),
        add_space_prefix=reader.get("tokenizer.ggml.add_space_prefix", True),
        chat_template=reader.get("tokenizer.chat_template"),
    )
