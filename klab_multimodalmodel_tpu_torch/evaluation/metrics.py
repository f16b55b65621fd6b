"""Caption quality metrics: CIDEr-D, BLEU-1..4 and ROUGE-L, PTB-tokenized.

The port's own copy of the JAX package's ``evaluation/metrics.py`` (pure
Python; the port imports nothing of the JAX package), with the same floats.
CIDEr-D follows the official pycocoevalcap ``cider_scorer.py`` algorithm
(tf-idf weighted n-gram cosine with the sigma=6 length gaussian, scores
x10); BLEU is standard corpus BLEU with brevity penalty and closest-length
effective reference (pycocoevalcap's default), reported cumulative at
n=1..4; ROUGE-L follows pycocoevalcap ``rouge.py`` (per-image LCS
precision/recall maxed over references, beta=1.2 F-measure, corpus mean).
Of the official COCO-caption five, METEOR and SPICE are deliberately absent:
both are thin wrappers around bundled Java artifacts (meteor-1.5.jar with
its WordNet/paraphrase data files; the Stanford scene-graph parser) — there
is no published pure algorithm to port faithfully, and shipping a lookalike
would produce numbers incomparable with every published METEOR/SPICE score.

Tokenization defaults to ``ptb_tokenize`` — a faithful port of what
pycocoevalcap's ``PTBTokenizer`` does (Stanford PTBTokenizer via Java with
``-preserveLines -lowerCase``, then removal of its ``PUNCTUATIONS`` token
list): the Penn-Treebank sed-script rules (contraction splitting, quote
normalization to \\`\\`/'', -LRB-/-RRB- bracket forms, final-period and
ellipsis handling), lowercased, with the official punctuation tokens
dropped — including the official quirk that lowercased bracket tokens
(``-lrb-`` …) survive the uppercase removal list. Scores computed here
therefore use the same token streams as any externally published
COCO-caption number. ``simple_tokenize`` remains as a dependency-free
fallback.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

_PUNCT = re.compile(r"[^\w\s]")


def simple_tokenize(text: str) -> List[str]:
    """Lowercase, strip punctuation, whitespace split (a light stand-in for
    the PTB tokenizer; not used by the official-semantics default)."""
    return _PUNCT.sub("", text.lower()).split()


# ---------------------------------------------------------------------------
# Penn Treebank tokenizer (the sed-script rule set Stanford's PTBTokenizer
# implements; identical rule order to the canonical public port)
# ---------------------------------------------------------------------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION_RULES = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period (keeps abbreviation-internal periods like "U.S." intact)
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_CONVERT_PARENTHESES = [
    (re.compile(r"\("), " -LRB- "), (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "), (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "), (re.compile(r"\}"), " -RCB- "),
]
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(not)\b", r"(?i)\b(d)('ye)\b", r"(?i)\b(gim)(me)\b",
    r"(?i)\b(gon)(na)\b", r"(?i)\b(got)(ta)\b", r"(?i)\b(lem)(me)\b",
    r"(?i)\b(mor)('n)\b", r"(?i)\b(wan)(na)(?=\s)")]
_CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(is)\b", r"(?i) ('t)(was)\b")]

# pycocoevalcap tokenizer.py PUNCTUATIONS — tokens the official COCO eval
# drops after PTB tokenization (note: -LSB-/-RSB- are deliberately absent
# there, so they are kept here too; and since the official filter runs on
# ALREADY-LOWERCASED tokens, the uppercase bracket entries below never
# match anything — see ptb_tokenize).
PTB_PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";"])


def _treebank_tokens(text: str) -> List[str]:
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION_RULES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _CONVERT_PARENTHESES:
        text = regexp.sub(substitution, text)
    text = _DOUBLE_DASHES[0].sub(_DOUBLE_DASHES[1], text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def ptb_tokenize(text: str) -> List[str]:
    """Official COCO-eval tokenization: PTB rules, lowercase, punctuation
    tokens removed (pycocoevalcap ``PTBTokenizer.tokenize`` semantics).

    Order matters: the official pipeline lowercases FIRST (the Java
    tokenizer runs with ``-lowerCase``) and only then filters against the
    uppercase ``PUNCTUATIONS`` list — so bracket tokens come through as
    ``-lrb-``/``-rrb-``/``-lcb-``/``-rcb-`` and are KEPT (they never match
    the uppercase list entries), while the case-invariant punctuation
    tokens are dropped. A filter on the pre-lowercase tokens would drop
    brackets and diverge from every externally published COCO number on
    bracket-containing captions."""
    return [t for t in (tok.lower() for tok in _treebank_tokens(text))
            if t not in PTB_PUNCTUATIONS]


def _check_lengths(candidates: Sequence[str],
                   references: Sequence[Sequence[str]]) -> None:
    if len(candidates) != len(references):
        raise ValueError(f"{len(candidates)} candidates but "
                         f"{len(references)} reference sets")


def _ngrams(tokens: Sequence[str], max_n: int = 4) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


class CiderScorer:
    """CIDEr-D over a corpus of (candidate, [references])."""

    def __init__(self, max_n: int = 4, sigma: float = 6.0,
                 tokenizer=ptb_tokenize):
        self.max_n = max_n
        self.sigma = sigma
        self.tokenizer = tokenizer

    def compute(self, candidates: Sequence[str],
                references: Sequence[Sequence[str]]) -> float:
        _check_lengths(candidates, references)
        tok = self.tokenizer
        cand_counts = [_ngrams(tok(c), self.max_n) for c in candidates]
        ref_counts = [[_ngrams(tok(r), self.max_n) for r in refs]
                      for refs in references]

        # document frequency over reference sets
        df: Dict[tuple, float] = defaultdict(float)
        for refs in ref_counts:
            for ngram in set(ng for r in refs for ng in r):
                df[ngram] += 1.0
        log_n = math.log(max(len(references), 1))

        def counts2vec(cnts: Counter):
            vec = [defaultdict(float) for _ in range(self.max_n)]
            norm = [0.0] * self.max_n
            length = 0
            for ngram, tf in cnts.items():
                d = math.log(max(1.0, df[ngram]))
                ni = len(ngram) - 1
                vec[ni][ngram] = tf * (log_n - d)
                norm[ni] += vec[ni][ngram] ** 2
                if ni == 1:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        total = 0.0
        for c_cnt, refs in zip(cand_counts, ref_counts):
            c_vec, c_norm, c_len = counts2vec(c_cnt)
            score_n = [0.0] * self.max_n
            for r_cnt in refs:
                r_vec, r_norm, r_len = counts2vec(r_cnt)
                delta = float(c_len - r_len)
                for ni in range(self.max_n):
                    val = 0.0
                    for ngram, rv in r_vec[ni].items():
                        # CIDEr-D clips the candidate tf-idf at the ref's
                        val += min(c_vec[ni].get(ngram, 0.0), rv) * rv
                    if c_norm[ni] != 0 and r_norm[ni] != 0:
                        val /= c_norm[ni] * r_norm[ni]
                    val *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
                    score_n[ni] += val
            n_ref = max(len(refs), 1)
            total += 10.0 * sum(s / n_ref for s in score_n) / self.max_n
        return total / max(len(candidates), 1)


def cider_d(candidates: Sequence[str],
            references: Sequence[Sequence[str]],
            tokenizer=ptb_tokenize) -> float:
    return CiderScorer(tokenizer=tokenizer).compute(candidates, references)


# pycocoevalcap bleu_scorer.py smoothing constants: clipped+tiny over
# guess+small keeps zero-match orders at a tiny nonzero score instead of a
# hard 0.0 (small early-training eval sets would otherwise log BLEU-3/4 = 0
# where the official scorer gives ~1e-9-scale values).
_BLEU_TINY = 1e-15
_BLEU_SMALL = 1e-9


def _bleu_corpus_counts(candidates: Sequence[str],
                        references: Sequence[Sequence[str]],
                        max_n: int, tokenizer):
    """One tokenize+count pass shared by every BLEU order: per-n clipped
    and total n-gram counts plus the corpus candidate/closest-reference
    lengths (pycocoevalcap's 'closest' reflen option)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        c_toks = tokenizer(cand)
        r_toks = [tokenizer(r) for r in refs]
        cand_len += len(c_toks)
        ref_len += min((abs(len(r) - len(c_toks)), len(r))
                       for r in r_toks)[1] if r_toks else 0
        for n in range(1, max_n + 1):
            c_ngr = Counter(tuple(c_toks[i:i + n])
                            for i in range(len(c_toks) - n + 1))
            max_ref: Counter = Counter()
            for r in r_toks:
                r_ngr = Counter(tuple(r[i:i + n])
                                for i in range(len(r) - n + 1))
                for ng, cnt in r_ngr.items():
                    max_ref[ng] = max(max_ref[ng], cnt)
            totals[n - 1] += sum(c_ngr.values())
            clipped[n - 1] += sum(min(cnt, max_ref[ng])
                                  for ng, cnt in c_ngr.items())
    return clipped, totals, cand_len, ref_len


def bleu_n(candidates: Sequence[str],
           references: Sequence[Sequence[str]],
           max_n: int = 4, tokenizer=ptb_tokenize) -> List[float]:
    """Cumulative BLEU-1..max_n — the pycocoevalcap ``Bleu`` four-tuple
    with the official scorer's semantics: closest-length effective
    reference, tiny/small-smoothed precision ratios (bleu_scorer.py's
    corpus path), brevity penalty ``exp(1 - 1/ratio)`` when the candidate
    corpus is shorter. All orders derive from one shared counting pass."""
    clipped, totals, cand_len, ref_len = _bleu_corpus_counts(
        candidates, references, max_n, tokenizer)
    prod = 1.0
    bleus = []
    for k in range(max_n):
        prod *= (clipped[k] + _BLEU_TINY) / (totals[k] + _BLEU_SMALL)
        bleus.append(prod ** (1.0 / (k + 1)))
    ratio = (cand_len + _BLEU_TINY) / (ref_len + _BLEU_SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


def bleu(candidates: Sequence[str], references: Sequence[Sequence[str]],
         max_n: int = 4, tokenizer=ptb_tokenize) -> float:
    """Corpus BLEU-N (the last entry of the cumulative ``bleu_n`` tuple)."""
    return bleu_n(candidates, references, max_n=max_n,
                  tokenizer=tokenizer)[-1]


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Longest-common-subsequence length (the classic DP, rolling row)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y
                       else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: Sequence[str],
            references: Sequence[Sequence[str]],
            beta: float = 1.2, tokenizer=ptb_tokenize) -> float:
    """ROUGE-L with official pycocoevalcap ``rouge.py`` semantics.

    Per image: LCS precision/recall against EACH reference, each maxed
    independently over the reference set (the official scorer takes
    ``max(prec)`` and ``max(rec)`` separately — possibly from different
    references), combined as an F-measure with beta=1.2; the corpus score
    is the plain mean. An empty candidate (or empty reference) contributes
    0 for that pair, matching the official guard ``prec_max != 0 and
    rec_max != 0``."""
    _check_lengths(candidates, references)
    if not candidates:
        return 0.0
    total = 0.0
    for cand, refs in zip(candidates, references):
        c_toks = tokenizer(cand)
        prec_max = rec_max = 0.0
        for ref in refs:
            r_toks = tokenizer(ref)
            if not c_toks or not r_toks:
                continue
            lcs = _lcs_len(c_toks, r_toks)
            prec_max = max(prec_max, lcs / len(c_toks))
            rec_max = max(rec_max, lcs / len(r_toks))
        if prec_max != 0 and rec_max != 0:
            total += ((1 + beta ** 2) * prec_max * rec_max
                      / (rec_max + beta ** 2 * prec_max))
    return total / len(candidates)
