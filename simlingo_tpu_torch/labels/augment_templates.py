"""Paraphrase-template generation for commentary/QA augmentation.

Copy of `simlingo_tpu/labels/augment_templates.py`.

Behavioral counterpart of reference `dataset_generation/get_augmentations/`
(gpt_augment_vqa.py, commentary_merge_augmented.py): generate N paraphrases
per template sentence (offline, once) and write
`augmented_templates/*.json` consumed by the training datasets
(data/driving_dataset.py template augmentation).

Uses an OpenAI-compatible endpoint when configured; otherwise a rule-based
paraphraser (synonym + clause reordering) so the augmentation path works in
closed environments.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

SYNONYMS = {
    "accelerates": ["speeds up", "picks up speed", "increases its speed"],
    "slows down": ["decelerates", "reduces speed", "brakes gently"],
    "stops": ["comes to a stop", "halts", "brakes to a standstill"],
    "maintains": ["keeps", "holds", "continues at"],
    "remains stopped": ["stays stationary", "keeps standing still"],
    "follows the road": ["continues along the road", "keeps following the road"],
    "turns left": ["makes a left turn", "takes a left"],
    "turns right": ["makes a right turn", "takes a right"],
    "because of": ["due to", "on account of"],
    "the ego vehicle": ["the car", "the vehicle", "the ego car"],
    "changes to the left lane": ["moves into the left lane",
                                 "performs a lane change to the left"],
    "changes to the right lane": ["moves into the right lane",
                                  "performs a lane change to the right"],
}


def rule_based_paraphrases(sentence: str, n: int = 4) -> List[str]:
    """Deterministic paraphrases via synonym substitution."""
    variants = {sentence}
    frontier = [sentence]
    while frontier and len(variants) < n + 1:
        cur = frontier.pop(0)
        for key, subs in SYNONYMS.items():
            if key in cur.lower():
                idx = cur.lower().index(key)
                for sub in subs:
                    cand = cur[:idx] + sub + cur[idx + len(key):]
                    if cand not in variants:
                        variants.add(cand)
                        frontier.append(cand)
                    if len(variants) >= n + 1:
                        break
            if len(variants) >= n + 1:
                break
    out = [v for v in variants if v != sentence][:n]
    return out or [sentence]


def gpt_paraphrases(sentence: str, n: int = 4, model: str = "gpt-4o-mini",
                    api_key: Optional[str] = None) -> Optional[List[str]]:
    api_key = api_key or os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return None
    from openai import OpenAI
    client = OpenAI(api_key=api_key)
    prompt = (f"Rewrite the following driving commentary in {n} different "
              f"ways, keeping any <PLACEHOLDER> tokens intact. Reply with "
              f"one rewrite per line.\n\n{sentence}")
    resp = client.chat.completions.create(
        model=model, messages=[{"role": "user", "content": prompt}])
    lines = [l.strip("- ").strip() for l in
             resp.choices[0].message.content.splitlines() if l.strip()]
    return lines[:n] or None


def augment_templates(templates: Sequence[str], n: int = 4,
                      use_gpt: bool = True) -> Dict[str, List[str]]:
    """template sentence -> [paraphrases] (always includes the original)."""
    out: Dict[str, List[str]] = {}
    for t in templates:
        para = gpt_paraphrases(t, n) if use_gpt else None
        if para is None:
            para = rule_based_paraphrases(t, n)
        # keep placeholders intact
        ph = set(re.findall(r"<[A-Z_]+>", t))
        para = [p for p in para if set(re.findall(r"<[A-Z_]+>", p)) == ph]
        out[t] = [t] + para
    return out


def write_augmented_commentary(all_templates: Sequence[str], out_dir: str,
                               n: int = 4, use_gpt: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "commentary_augmented.json")
    with open(path, "w") as f:
        json.dump(augment_templates(all_templates, n, use_gpt), f, indent=2)
    return path


def main(argv=None) -> None:
    """CLI (<- reference get_augmentations/gpt_augment_vqa.py +
    commentary_merge_augmented.py):

        python -m simlingo_tpu_torch.labels.augment_templates <templates.json> \
            --out data/augmented_templates [--n 4] [--no-gpt]

    <templates.json> is a JSON list of template strings (the commentary /
    VQA generators write `all_templates`); emits the augmented-template
    json the datasets load at training time."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("templates_json")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--no-gpt", action="store_true",
                    help="rule-based paraphrases only (no API calls)")
    args = ap.parse_args(argv)
    with open(args.templates_json) as f:
        templates = json.load(f)
    path = write_augmented_commentary(templates, args.out, n=args.n,
                                      use_gpt=not args.no_gpt)
    print(path)


if __name__ == "__main__":
    main()
