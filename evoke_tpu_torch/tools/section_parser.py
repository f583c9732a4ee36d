"""Radiology report section parser.

Capability parity: EVOKE modules/section_parser.py (the MIMIC-CXR zenodo
splitter): split a raw report into sections keyed by normalized names
(findings / impression / indication / comparison / ...). This is an original
regex implementation of the same contract — headers are ``NAME:`` lines
(uppercase-leading, short), content runs to the next header.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# canonical names for the common MIMIC-CXR section headers
_NORMALIZE = {
    "findings": "findings",
    "finding": "findings",
    "impression": "impression",
    "impressions": "impression",
    "conclusion": "impression",
    "indication": "indication",
    "history": "indication",
    "clinical history": "indication",
    "clinical indication": "indication",
    "reason for exam": "indication",
    "reason for examination": "indication",
    "comparison": "comparison",
    "comparisons": "comparison",
    "technique": "technique",
    "examination": "examination",
    "exam": "examination",
    "wet read": "wet_read",
    "final report": "preamble",
    "recommendation": "recommendation",
    "recommendations": "recommendation",
    "notification": "notification",
    "impression and recommendation": "impression",
}

# a header: optional leading whitespace, 1-5 words of letters/spaces, a colon.
_HEADER_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z ]{1,40}?)\s*:", re.MULTILINE)


def normalize_section_name(name: str) -> str:
    return _NORMALIZE.get(name.strip().lower(), name.strip().lower().replace(" ", "_"))


def section_text(text: str) -> Tuple[List[str], List[str], List[int]]:
    """-> (section_texts, normalized_names, start_indices).

    Text before the first header lands in a 'preamble' section when non-empty.
    """
    sections: List[str] = []
    names: List[str] = []
    starts: List[int] = []

    matches = list(_HEADER_RE.finditer(text))
    if not matches:
        body = text.strip()
        return ([body] if body else []), (["full_report"] if body else []), ([0] if body else [])

    first = matches[0]
    pre = text[: first.start()].strip()
    if pre:
        sections.append(pre)
        names.append("preamble")
        starts.append(0)
    for i, m in enumerate(matches):
        end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
        body = text[m.end(): end].strip()
        sections.append(body)
        names.append(normalize_section_name(m.group(1)))
        starts.append(m.start())
    return sections, names, starts


def extract_section(text: str, wanted: str) -> str:
    """Convenience: the (last) section with the given normalized name, or ''."""
    sections, names, _ = section_text(text)
    out = ""
    for body, name in zip(sections, names):
        if name == wanted:
            out = body
    return out
