"""Eval-set files: loading the reference format + building our own.

Copy of `simlingo_tpu/eval/eval_sets.py`, on the port's
`data/index.py:SampleIndex`.

Counterpart of reference `data/evalset_vqa.json` / `evalset_commentary.json`
selection (dataset_base.py:86-114): VQA eval sets map
{question_template: {answer_template: [vqa file paths]}}; commentary sets map
{template: [commentary file paths]}. Paths are converted back to
(route_dir, frame) and matched against a SampleIndex so the eval runner can
iterate deterministic samples.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from simlingo_tpu_torch.data.index import SampleIndex


def _to_measurement_path(path: str) -> str:
    """vqa/commentary label path -> measurements path (both layouts)."""
    p = path.replace("/drivelm/", "/data/").replace("/commentary/simlingo",
                                                    "/data/simlingo")
    p = re.sub(r"/(vqa|commentary|dreamer)/(\d+\.json\.gz)$",
               r"/measurements/\2", p)
    return p


def parse_eval_set(path: str, mode: str = "QA"
                   ) -> List[Tuple[str, Optional[Tuple[str, str]]]]:
    """-> [(measurement_path, (question_template, answer_template) | None)]."""
    with open(path) as f:
        data = json.load(f)
    out: List[Tuple[str, Optional[Tuple[str, str]]]] = []
    if mode == "QA":
        for question, answers in data.items():
            if "important objects" in question:
                continue  # excluded by the reference (dataset_base.py:98-100)
            for answer, samples in answers.items():
                for s in samples:
                    out.append((_to_measurement_path(s), (question, answer)))
    else:
        for template, samples in data.items():
            for s in samples:
                out.append((_to_measurement_path(s), None))
    return out


def match_index(index: SampleIndex, entries: Sequence[Tuple[str, Optional[Tuple]]]
                ) -> List[Tuple[int, Optional[Tuple[str, str]]]]:
    """Map (measurement_path, template) entries to dataset indices."""
    lookup: Dict[Tuple[str, int], int] = {}
    for i in range(len(index)):
        lookup[(index.route_dir(i), int(index.frame[i]))] = i
    out = []
    for path, template in entries:
        route_dir = os.path.dirname(os.path.dirname(path))
        frame = int(os.path.basename(path).split(".")[0])
        idx = lookup.get((route_dir, frame))
        if idx is not None:
            out.append((idx, template))
    return out


def build_eval_set(data_root: str, mode: str = "QA",
                   samples_per_template: int = 10,
                   seed: int = 0) -> Dict:
    """Build an eval-set file from generated labels (the reference ships
    hand-curated ones; this produces the same structure from our own
    generators so evaluation works on any collected dataset)."""
    import glob
    import gzip

    rng = np.random.RandomState(seed)
    pattern = os.path.join(data_root, "data", "simlingo", "*", "*", "*",
                           "Town*")
    routes = sorted(glob.glob(pattern))
    grouped: Dict = {}
    for route in routes:
        sub = "vqa" if mode == "QA" else "commentary"
        for f in sorted(glob.glob(os.path.join(route, sub, "*.json.gz"))):
            with gzip.open(f, "rt") as fh:
                rec = json.load(fh)
            if mode == "QA":
                for cat, qas in rec["QA"].items():
                    for qa in qas:
                        grouped.setdefault(qa["Q"], {}).setdefault(
                            qa["A"], []).append(f)
            else:
                grouped.setdefault(rec["commentary_template"], []).append(f)

    def sample(lst):
        if len(lst) <= samples_per_template:
            return lst
        picks = rng.choice(len(lst), samples_per_template, replace=False)
        return [lst[i] for i in picks]

    if mode == "QA":
        return {q: {a: sample(v) for a, v in answers.items()}
                for q, answers in grouped.items()}
    return {t: sample(v) for t, v in grouped.items()}
