"""Ground truth for `utils/metrics.py`: the port's own copy of
`tuatara_tpu/utils/data.py:load_funsd_annotations` (the part the command
line's `--eval` reads)."""

from __future__ import annotations

import json
from typing import Dict, List


def load_funsd_annotations(path: str, level: str = "word") -> List[Dict]:
    """One FUNSD annotation file ({"form": [{"text", "box": [x0, y0, x1,
    y1], "words": [{"text", "box"}, ...]}, ...]}) -> [{"text", "bbox"}] at
    `level`: "word" (one entry a word, what the engine emits) or "entity"
    (one a form field, for line-level output). Entries with empty text
    (checkboxes, empty fields) are dropped."""
    with open(path) as f:
        form = json.load(f)["form"]
    out: List[Dict] = []
    if level == "word":
        for field in form:
            for wrd in field.get("words", []):
                if wrd.get("text", "").strip():
                    out.append({"text": wrd["text"], "bbox": [float(v) for v in wrd["box"]]})
    elif level == "entity":
        for field in form:
            if field.get("text", "").strip():
                out.append({"text": field["text"], "bbox": [float(v) for v in field["box"]]})
    else:
        raise ValueError(f"level must be 'word' or 'entity', got {level!r}")
    return out
