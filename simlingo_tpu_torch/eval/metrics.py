"""Language evaluation metrics: exact match, BLEU, ROUGE-L, CIDEr, METEOR.

Copy of `simlingo_tpu/eval/metrics.py` (numpy; nltk's WordNet and
`openai` are imported lazily, and `gpt_judge` returns None without
$OPENAI_API_KEY).

Counterpart of reference `eval_metrics.py` (evaluation_suit): exact-match
accuracy + NLG metrics. The reference shells out to the `language_evaluation`
CocoEvaluator (BLEU/ROUGE-L/CIDEr/METEOR/SPICE) and a GPT-4o judge; here
BLEU-1..4, ROUGE-L, CIDEr, METEOR and SPICE are implemented directly in
python/numpy. `gpt_judge` fans out over a 16-thread pool like the
reference's Pool(16).

Comparability with published SimLingo numbers, metric by metric:
  * accuracy, BLEU, ROUGE-L, CIDEr — same formulas as pycocoevalcap
    (modulo its PTB tokenizer; ours is a lowercase/punctuation-strip
    tokenizer): directly comparable for the templated driving corpus,
    which contains no PTB-relevant constructs (contractions, quotes).
  * METEOR — exact + Porter-stem + WordNet-synonymy stages. The synonym
    stage activates only when a WordNet corpus is installed (nltk data
    path or $SIMLINGO_WORDNET_DIR; wordnet_synonyms()); without it,
    scores are a strict lower bound on the reference's METEOR.
  * SPICE — a lexicon scene-graph F1 ANALOGUE (same tuple-F1 scoring
    over (object, attribute, relation) triples, rule-based chunker
    instead of the Java corenlp dependency parse): NOT numerically
    comparable to published SPICE; use for relative comparisons between
    runs of this framework only.
  * gpt_judge — same prompt/scale; comparable given the same judge model.
"""

from __future__ import annotations

import math
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _tokenize(s: str) -> List[str]:
    s = s.lower()
    s = re.sub(r"[^a-z0-9 ]+", " ", s)
    return s.split()


def exact_match(preds: Sequence[str], refs: Sequence[str]) -> float:
    ok = [p.strip() == r.strip() for p, r in zip(preds, refs)]
    return float(np.mean(ok)) if ok else 0.0


# ---------------------------------------------------------------------------
# BLEU (corpus-level, uniform weights, with brevity penalty)
# ---------------------------------------------------------------------------

def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(preds: Sequence[str], refs: Sequence[str], max_n: int = 4
         ) -> Dict[str, float]:
    clipped = [0] * max_n
    totals = [0] * max_n
    pred_len = 0
    ref_len = 0
    for p, r in zip(preds, refs):
        pt, rt = _tokenize(p), _tokenize(r)
        pred_len += len(pt)
        ref_len += len(rt)
        for n in range(1, max_n + 1):
            pn = _ngrams(pt, n)
            rn = _ngrams(rt, n)
            totals[n - 1] += sum(pn.values())
            clipped[n - 1] += sum(min(c, rn[g]) for g, c in pn.items())
    out = {}
    log_precisions = []
    for n in range(1, max_n + 1):
        prec = clipped[n - 1] / totals[n - 1] if totals[n - 1] else 0.0
        log_precisions.append(math.log(prec) if prec > 0 else -1e9)
        cum = math.exp(sum(log_precisions) / n)
        bp = 1.0 if pred_len > ref_len else math.exp(
            1 - ref_len / max(pred_len, 1))
        out[f"bleu_{n}"] = bp * cum
    return out


# ---------------------------------------------------------------------------
# ROUGE-L (sentence-level F, averaged)
# ---------------------------------------------------------------------------

def _lcs(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        prev = 0
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(preds: Sequence[str], refs: Sequence[str],
            beta: float = 1.2) -> float:
    scores = []
    for p, r in zip(preds, refs):
        pt, rt = _tokenize(p), _tokenize(r)
        if not pt or not rt:
            scores.append(0.0)
            continue
        lcs = _lcs(pt, rt)
        prec = lcs / len(pt)
        rec = lcs / len(rt)
        if prec == 0 or rec == 0:
            scores.append(0.0)
        else:
            scores.append((1 + beta ** 2) * prec * rec
                          / (rec + beta ** 2 * prec))
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr (tf-idf weighted n-gram cosine, n=1..4, sigma length penalty)
# ---------------------------------------------------------------------------

def cider(preds: Sequence[str], refs: Sequence[str], max_n: int = 4,
          sigma: float = 6.0) -> float:
    pred_tok = [_tokenize(p) for p in preds]
    ref_tok = [_tokenize(r) for r in refs]
    N = len(refs)
    if N == 0:
        return 0.0
    # document frequency over the reference corpus
    df = [defaultdict(float) for _ in range(max_n)]
    for rt in ref_tok:
        for n in range(1, max_n + 1):
            for g in set(_ngrams(rt, n)):
                df[n - 1][g] += 1.0

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        total = max(sum(cnt.values()), 1)
        vec = {}
        for g, c in cnt.items():
            idf = math.log(max(N, 1)) - math.log(max(df[n - 1].get(g, 0.0), 1.0))
            vec[g] = (c / total) * idf
        return vec

    scores = []
    for pt, rt in zip(pred_tok, ref_tok):
        score_n = []
        for n in range(1, max_n + 1):
            vp = tfidf_vec(pt, n)
            vr = tfidf_vec(rt, n)
            num = sum(min(vp.get(g, 0), vr.get(g, 0)) * vr[g] for g in vr)
            norm_p = math.sqrt(sum(v * v for v in vp.values()))
            norm_r = math.sqrt(sum(v * v for v in vr.values()))
            sim = num / (norm_p * norm_r) if norm_p > 0 and norm_r > 0 else 0.0
            delta = len(pt) - len(rt)
            sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
            score_n.append(sim)
        scores.append(10.0 * float(np.mean(score_n)))
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# METEOR (unigram alignment with exact + Porter-stem stages)
# ---------------------------------------------------------------------------

_VOWELS = set("aeiou")


def _porter_stem(w: str) -> str:
    """Compact Porter stemmer (steps 1a/1b/1c + common suffix strips).

    Enough stemming power for METEOR's stem-match stage (maps inflected
    forms -- braking/brakes/braked -> brake-ish stems); not a full Porter
    implementation, but deterministic and dependency-free.
    """
    if len(w) <= 3:
        return w

    def has_vowel(s):
        return any(c in _VOWELS or (c == "y" and i > 0)
                   for i, c in enumerate(s))

    # step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("s") and not w.endswith("ss"):
        w = w[:-1]
    def measure(s):
        # Porter's m: number of VC sequences in the c*(vc)^m v* form
        seq = "".join("v" if (c in _VOWELS or (c == "y" and i > 0
                              and s[i - 1] not in _VOWELS)) else "c"
                      for i, c in enumerate(s))
        return seq.count("vc")

    def ends_cvc(s):
        return (len(s) >= 3 and s[-1] not in _VOWELS and s[-1] not in "wxy"
                and s[-2] in _VOWELS and s[-3] not in _VOWELS)

    # step 1b: -ed / -ing
    for suf in ("ing", "ed"):
        if w.endswith(suf) and has_vowel(w[:-len(suf)]):
            w = w[:-len(suf)]
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif (len(w) >= 2 and w[-1] == w[-2]
                  and w[-1] not in "lsz" and w[-1] not in _VOWELS):
                w = w[:-1]
            elif measure(w) == 1 and ends_cvc(w):
                w += "e"
            break
    # step 1c: -y -> i
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # common derivational suffixes
    for suf in ("ization", "fulness", "ousness", "ational", "iveness",
                "tional", "alism", "ation", "izer", "ator", "ment", "ness",
                "able", "ible", "ful"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[:-len(suf)]
            break
    return w


_WORDNET = None     # lazy tri-state: None = unchecked, False = absent


def wordnet_synonyms(word: str) -> set:
    """Synonym set from the WordNet corpus, or empty set when no corpus
    is installed (corpus-file check: nltk data path, optionally extended
    with $SIMLINGO_WORDNET_DIR). The reference reaches the same stage
    through pycocoevalcap's METEOR jar, which bundles WordNet; in this
    environment the corpus is absent and the stage is skipped —
    documented in the module docstring (published-number comparability).
    """
    global _WORDNET
    if _WORDNET is None:
        try:
            import nltk
            extra = os.environ.get("SIMLINGO_WORDNET_DIR")
            if extra and extra not in nltk.data.path:
                nltk.data.path.append(extra)
            from nltk.corpus import wordnet as wn
            wn.synsets("car")               # force the corpus load now
            _WORDNET = wn
        except Exception:
            _WORDNET = False
    if not _WORDNET:
        return set()
    return {lemma.name().lower().replace("_", " ")
            for syn in _WORDNET.synsets(word) for lemma in syn.lemmas()}


def _meteor_align(hyp: List[str], ref: List[str],
                  synonyms=None) -> List[Tuple[int, int]]:
    """Greedy staged alignment (exact, stem, then synonym), NLTK-style:
    each stage matches remaining unmatched hypothesis words to the first
    remaining compatible reference word, in position order. The synonym
    stage runs only when a provider yields non-empty sets (WordNet when
    its corpus is installed)."""
    pairs: List[Tuple[int, int]] = []
    h_free = set(range(len(hyp)))
    r_free = set(range(len(ref)))
    for stage in (lambda t: t, _porter_stem):
        ref_keys = {j: stage(ref[j]) for j in sorted(r_free)}
        for i in sorted(h_free):
            key = stage(hyp[i])
            for j in sorted(r_free):
                if ref_keys.get(j) == key:
                    pairs.append((i, j))
                    h_free.discard(i)
                    r_free.discard(j)
                    break
    if synonyms is not None and h_free and r_free:
        # NLTK meteor wordnetsyn_match: hyp word matches a ref word when
        # the ref word is among the hyp word's synset lemmas (or equal)
        for i in sorted(h_free):
            syns = synonyms(hyp[i])
            if not syns:
                continue
            syns = syns | {hyp[i]}
            for j in sorted(r_free):
                if ref[j] in syns:
                    pairs.append((i, j))
                    h_free.discard(i)
                    r_free.discard(j)
                    break
    return sorted(pairs)


def meteor(preds: Sequence[str], refs: Sequence[str], alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5,
           synonyms=wordnet_synonyms) -> float:
    """Sentence-level METEOR averaged over the corpus.

    F_mean = P*R / (alpha*P + (1-alpha)*R); fragmentation penalty
    gamma * (chunks / matches)^beta; standard parameters (0.9, 3, 0.5).
    Alignment stages: exact, Porter stem, and — when a WordNet corpus is
    installed (see wordnet_synonyms) — synonymy, matching the reference's
    METEOR configuration. `synonyms` is injectable for testing/custom
    lexica; pass None to disable the stage.
    """
    scores = []
    for p, r in zip(preds, refs):
        hyp, ref = _tokenize(p), _tokenize(r)
        if not hyp or not ref:
            scores.append(0.0)
            continue
        pairs = _meteor_align(hyp, ref, synonyms=synonyms)
        m = len(pairs)
        if m == 0:
            scores.append(0.0)
            continue
        prec = m / len(hyp)
        rec = m / len(ref)
        fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
        # chunks: maximal runs contiguous in both hyp and ref order
        chunks = 1
        for (h0, r0), (h1, r1) in zip(pairs, pairs[1:]):
            if not (h1 == h0 + 1 and r1 == r0 + 1):
                chunks += 1
        penalty = gamma * (chunks / m) ** beta
        scores.append(fmean * (1 - penalty))
    return float(np.mean(scores)) if scores else 0.0


# ---------------------------------------------------------------------------
# GPT judge (optional, reference utils/gpt_eval.py)
# ---------------------------------------------------------------------------

JUDGE_PROMPT = (
    "Rate the similarity in meaning of the two sentences on a scale from 0 "
    "to 100, where 100 means identical meaning. Reply with only the number.\n"
    "Sentence 1: {answer}\nSentence 2: {prediction}")


# ---------------------------------------------------------------------------
# SPICE (scene-graph tuple F1) -- lexicon-driven analogue
# ---------------------------------------------------------------------------

# driving-domain lexicon: our label generators and the reference's emit
# templated language over a closed object/attribute/relation vocabulary,
# so a lexicon chunker recovers the same tuples a dependency parse would
_SPICE_OBJECTS = (
    "traffic light", "stop sign", "speed limit", "construction site",
    "lane change", "target speed", "ego vehicle", "vehicle", "pedestrian",
    "walker", "bicycle", "car", "truck", "van", "bus", "ambulance",
    "firetruck", "police car", "junction", "intersection", "lane", "route",
    "road", "obstacle", "gap", "door", "sidewalk", "crosswalk",
)
_SPICE_ATTRIBUTES = (
    "red", "green", "yellow", "orange", "blue", "white", "black", "grey",
    "gray", "silver", "brown", "stationary", "stopped", "moving", "parked",
    "slow", "fast", "near", "nearby", "far", "left", "right", "front",
    "behind", "oncoming", "crossing", "broken", "solid", "open", "blocked",
    "clear", "important",
)
_SPICE_RELATIONS = (
    "stay behind", "drive closer", "change lanes", "changes to", "slow down",
    "slows down", "speed up", "accelerate", "accelerates", "decelerate",
    "brake", "stop", "stops", "follow", "follows", "yield", "yields",
    "bypass", "overtake", "wait", "waits", "turn left", "turn right",
    "cross", "crosses", "pay attention", "watch", "avoid", "maintains",
    "maintain", "exit", "affected by", "prepare",
)


def scene_tuples(text: str) -> set:
    """Extract (object), (attribute, object) and (relation, object) tuples."""
    t = " " + " ".join(_tokenize(text)) + " "
    tuples = set()
    for obj in _SPICE_OBJECTS:
        start = 0
        while True:
            i = t.find(" " + obj + " ", start)
            if i < 0:
                i = t.find(" " + obj + "s ", start)
                if i < 0:
                    break
            tuples.add((obj,))
            # attribute immediately before the object mention
            prefix = t[:i].split()
            if prefix and prefix[-1] in _SPICE_ATTRIBUTES:
                tuples.add((prefix[-1], obj))
            start = i + 1
    for rel in _SPICE_RELATIONS:
        if " " + rel + " " in t or " " + rel + "." in t:
            tuples.add(("rel", rel))
            # relation's object = first lexicon object after the relation
            after = t.split(" " + rel + " ", 1)
            if len(after) == 2:
                for obj in _SPICE_OBJECTS:
                    if " " + obj + " " in " " + after[1]:
                        tuples.add((rel, obj))
                        break
    for attr in _SPICE_ATTRIBUTES:
        if " " + attr + " " in t:
            tuples.add(("attr", attr))
    return tuples


def spice(preds: Sequence[str], refs: Sequence[str]) -> float:
    """Scene-graph tuple F1 (SPICE analogue; reference eval_metrics.py uses
    pycocoevalcap's Java SPICE -- this lexicon-driven extractor covers the
    closed driving-QA vocabulary both label generators emit)."""
    f1s = []
    for p, r in zip(preds, refs):
        tp_set = scene_tuples(p)
        ref_set = scene_tuples(r)
        if not ref_set and not tp_set:
            f1s.append(1.0)
            continue
        inter = len(tp_set & ref_set)
        prec = inter / len(tp_set) if tp_set else 0.0
        rec = inter / len(ref_set) if ref_set else 0.0
        f1s.append(0.0 if prec + rec == 0
                   else 2 * prec * rec / (prec + rec))
    return float(np.mean(f1s)) if f1s else 0.0


def gpt_judge(preds: Sequence[str], refs: Sequence[str],
              model: str = "gpt-4o", api_key: Optional[str] = None,
              base_url: Optional[str] = None,
              max_workers: int = 16) -> Optional[float]:
    """Average 0-100 judge score; returns None when no endpoint configured.

    Requests fan out over a 16-thread pool (the reference's eval_metrics.py:110
    uses Pool(16) for the same reason: judge latency dominates, the calls are
    independent). A request that errors or returns a non-numeric score is
    dropped from the mean, matching the serial behavior.
    """
    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return None
    from concurrent.futures import ThreadPoolExecutor
    from openai import OpenAI
    client = OpenAI(api_key=api_key, base_url=base_url)

    def one(pair):
        p, r = pair
        resp = client.chat.completions.create(
            model=model,
            messages=[{"role": "user", "content": JUDGE_PROMPT.format(
                answer=r, prediction=p)}])
        return float(resp.choices[0].message.content.strip())

    pairs = list(zip(preds, refs))
    scores = []
    with ThreadPoolExecutor(max_workers=min(max_workers, max(1, len(pairs)))) as ex:
        for fut in [ex.submit(one, pair) for pair in pairs]:
            try:
                scores.append(fut.result())
            except Exception:
                continue
    return float(np.mean(scores)) if scores else None


def evaluation_suite(preds: Sequence[str], refs: Sequence[str],
                     use_judge: bool = False) -> Dict[str, float]:
    out: Dict[str, float] = {"accuracy": exact_match(preds, refs)}
    out.update(bleu(preds, refs))
    out["rouge_l"] = rouge_l(preds, refs)
    out["cider"] = cider(preds, refs)
    out["meteor"] = meteor(preds, refs)
    out["spice"] = spice(preds, refs)
    if use_judge:
        j = gpt_judge(preds, refs)
        if j is not None:
            out["gpt_judge"] = j
    return out
