"""Minimal deterministic tokenizer for the graph-task corpora: the port's own
copy of ``repro.data.tokenizer`` (which imports no JAX), kept line for
line so that both packages emit the same tokens.

Vocabulary: digits/punct for serialized graphs + control tokens. Numbers are
tokenized digit-wise, so any key fits any vocab >= VOCAB_MIN.
"""
from __future__ import annotations

PAD, BOS, EOS, SEP, QUERY, PATH, NOPATH, EDGE = 0, 1, 2, 3, 4, 5, 6, 7
_DIGIT0 = 8
VOCAB_MIN = 18


def encode_int(n: int) -> list[int]:
    return [_DIGIT0 + int(c) for c in str(int(n))]


def encode_edge(u: int, v: int) -> list[int]:
    return [EDGE] + encode_int(u) + [SEP] + encode_int(v)


def encode_example(edges, src: int, dst: int, path) -> list[int]:
    """<bos> E u|v ... <query> s|t <path> v0|v1|... <eos>  (or <nopath>)."""
    toks = [BOS]
    for (u, v) in edges:
        toks += encode_edge(u, v)
    toks += [QUERY] + encode_int(src) + [SEP] + encode_int(dst)
    if path:
        toks += [PATH]
        for v in path:
            toks += encode_int(v) + [SEP]
    else:
        toks += [NOPATH]
    toks.append(EOS)
    return toks


def decode(tokens) -> str:
    names = {PAD: "_", BOS: "<s>", EOS: "</s>", SEP: "|", QUERY: "?",
             PATH: "=>", NOPATH: "=>NONE", EDGE: "E"}
    out = []
    for t in tokens:
        t = int(t)
        if t in names:
            out.append(names[t])
        elif t >= _DIGIT0:
            out.append(str(t - _DIGIT0))
    return "".join(out)
