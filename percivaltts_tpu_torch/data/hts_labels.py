"""HTS full-context label parsing + question-set binarization (the port's
copy of ``percivaltts_tpu/data/hts_labels.py``; both give equal arrays).

The stage that turns HTS full-context label files (state- or phone-aligned)
into per-frame numeric input vectors, after Merlin's label normalization:

* binary answers to a Merlin-style question set (``QS`` lines of a ``.hed``
  file, glob-ish patterns over the full-context string),
* continuous question values (``CQS`` lines, regex captures of numbers
  embedded in the label),
* subphone/frame position features (state index, forward/backward fractions
  through state and phone, durations).

Question matching happens once per label segment (state or phone) on the
host; frame expansion is a vectorized numpy broadcast. The resulting
``(frames, label_dim)`` float32 array is what ships to the device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# HTS label times are in 100 ns units.
HTK_UNITS_PER_SEC = 10_000_000

# number of appended frame-position ("subphone") features, state-aligned mode
NUM_FRAME_FEATURES = 9
# number of HMM states per phone in standard HTS state alignment
NUM_STATES = 5


@dataclass
class LabelEntry:
    """One line of an HTS label file."""

    start: int  # in 100 ns units
    end: int
    label: str  # full-context label, state suffix stripped
    state: Optional[int]  # 2..6 for state-aligned labels, None otherwise

    @property
    def start_sec(self) -> float:
        return self.start / HTK_UNITS_PER_SEC

    @property
    def end_sec(self) -> float:
        return self.end / HTK_UNITS_PER_SEC


_STATE_RE = re.compile(r"^(.*)\[(\d+)\]$")


def parse_label_file(path: str) -> List[LabelEntry]:
    """Parse an HTS label file (state- or phone-aligned)."""
    entries: List[LabelEntry] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 3:
                start, end, lab = int(parts[0]), int(parts[1]), parts[2]
            elif len(parts) == 1:
                # alignment-free label (no times) — not supported for
                # frame-level features
                raise ValueError(
                    f"{path}: label line has no alignment times: {line!r}"
                )
            else:
                raise ValueError(f"{path}: cannot parse label line: {line!r}")
            m = _STATE_RE.match(lab)
            if m:
                entries.append(LabelEntry(start, end, m.group(1), int(m.group(2))))
            else:
                entries.append(LabelEntry(start, end, lab, None))
    if not entries:
        raise ValueError(f"{path}: empty label file")
    return entries


def _wildcard_to_regex(pattern: str) -> re.Pattern:
    """Convert a Merlin/HTK question pattern (``*``/``?`` wildcards,
    everything else literal) into an anchored regex over the full-context
    label."""
    out = []
    if not pattern.startswith("*"):
        out.append("^")
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(re.escape(ch))
    if not pattern.endswith("*"):
        out.append("$")
    return re.compile("".join(out))


# numeric tokens Merlin's CQS questions embed in otherwise-literal patterns
# (label_normalisation's convert_number_pattern forms); the parenthesized
# forms capture, the bare forms skip a number without capturing
_CQS_CAPTURES = (
    r"(\d+)",
    r"([\d\.]+)",
    r"([-\d]+)",
    r"([-\d\.]+)",
    r"\d+",
    r"[\d\.]+",
)


def _cqs_to_regex(pattern: str) -> re.Pattern:
    """Convert a Merlin CQS pattern to a regex.

    Everything is literal except ``*``/``?`` wildcards and the numeric
    capture tokens (``(\\d+)``, ``([\\d\\.]+)``, …), which pass through as
    capture groups. Full-context labels are full of regex metacharacters
    (``+ | $ . ! ;`` are slot delimiters), so escaping the literals is
    load-bearing: ``{/J:(\\d+)+}`` must match a literal ``+`` after the
    number, not apply a quantifier."""
    out = []
    i = 0
    while i < len(pattern):
        for tok in _CQS_CAPTURES:
            if pattern.startswith(tok, i):
                out.append(tok)
                i += len(tok)
                break
        else:
            ch = pattern[i]
            if ch == "*":
                out.append(".*")
            elif ch == "?":
                out.append(".")
            else:
                out.append(re.escape(ch))
            i += 1
    return re.compile("".join(out))


_QS_RE = re.compile(r'^(QS|CQS)\s+"([^"]+)"\s*\{(.*)\}\s*$')


@dataclass
class Question:
    kind: str  # "QS" | "CQS"
    name: str
    patterns: List[re.Pattern]


class QuestionSet:
    """A Merlin-style question set (.hed file).

    ``QS`` questions answer 1.0 if any pattern matches the label, else 0.0.
    ``CQS`` questions extract the first numeric capture group of their single
    pattern (0.0 when unmatched), e.g. ``CQS "Pos_Fw" {@(\\d+)_}``.
    """

    def __init__(self, questions: Sequence[Question]):
        self.questions = list(questions)

    @property
    def dim(self) -> int:
        return len(self.questions)

    @classmethod
    def from_hed(cls, path: str) -> "QuestionSet":
        questions: List[Question] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                m = _QS_RE.match(line)
                if not m:
                    continue
                kind, name, body = m.group(1), m.group(2), m.group(3)
                pats = [p.strip() for p in body.split(",") if p.strip()]
                if kind == "QS":
                    compiled = [_wildcard_to_regex(p) for p in pats]
                else:
                    compiled = [_cqs_to_regex(p) for p in pats]
                questions.append(Question(kind, name, compiled))
        if not questions:
            raise ValueError(f"{path}: no QS/CQS questions found")
        return cls(questions)

    def answer(self, label: str) -> np.ndarray:
        """Answer every question for one full-context label string."""
        out = np.zeros(len(self.questions), dtype=np.float32)
        for i, q in enumerate(self.questions):
            if q.kind == "QS":
                for pat in q.patterns:
                    if pat.search(label):
                        out[i] = 1.0
                        break
            else:
                for pat in q.patterns:
                    m = pat.search(label)
                    if not m:
                        continue
                    if m.lastindex:
                        # first numeric capture; malformed numbers (e.g. a
                        # lone "-" matched by [-\d]+) answer 0.0
                        try:
                            out[i] = float(m.group(1))
                        except ValueError:
                            out[i] = 0.0
                    else:
                        # a CQS pattern without a capture degenerates to a
                        # binary match (Merlin tolerates these)
                        out[i] = 1.0
                    break
        return out


def _group_phones(entries: Sequence[LabelEntry]) -> List[Tuple[int, int]]:
    """Group state-aligned entries into phones: list of (first_idx, last_idx)."""
    groups: List[Tuple[int, int]] = []
    start = 0
    for i, e in enumerate(entries):
        is_last = i == len(entries) - 1
        next_new_phone = (not is_last) and (
            entries[i + 1].state is None
            or entries[i + 1].state <= (e.state or 0)
            or entries[i + 1].label != e.label
        )
        if is_last or next_new_phone:
            groups.append((start, i))
            start = i + 1
    return groups


def binarize_labels(
    entries: Sequence[LabelEntry],
    questions: QuestionSet,
    shift_sec: float = 0.005,
    add_frame_features: bool = True,
) -> np.ndarray:
    """Expand parsed labels to per-frame numeric features.

    Returns ``(frames, questions.dim [+ NUM_FRAME_FEATURES])`` float32.

    Frame-position features (state-aligned labels; zeros where undefined):
      0. fraction through current state, forward  (0 → 1)
      1. fraction through current state, backward (1 → 0)
      2. state index within the phone, normalized to (state-1)/NUM_STATES
      3. state duration, seconds
      4. fraction through current phone, forward
      5. fraction through current phone, backward
      6. phone duration, seconds
      7. frame index within phone, forward, seconds
      8. frame index within phone, backward, seconds
    """
    shift_units = int(round(shift_sec * HTK_UNITS_PER_SEC))
    total_frames = int(round(entries[-1].end / shift_units))
    qdim = questions.dim
    dim = qdim + (NUM_FRAME_FEATURES if add_frame_features else 0)
    out = np.zeros((total_frames, dim), dtype=np.float32)

    # answer questions once per unique label string (states share the label)
    answers_cache: dict = {}

    def _ans(lab: str) -> np.ndarray:
        a = answers_cache.get(lab)
        if a is None:
            a = questions.answer(lab)
            answers_cache[lab] = a
        return a

    state_aligned = entries[0].state is not None
    phone_groups = (
        _group_phones(entries) if state_aligned else [(i, i) for i in range(len(entries))]
    )

    for g0, g1 in phone_groups:
        phone_start = entries[g0].start
        phone_end = entries[g1].end
        phone_dur_sec = (phone_end - phone_start) / HTK_UNITS_PER_SEC
        pf0 = phone_start // shift_units
        pf1 = min(int(round(phone_end / shift_units)), total_frames)
        for si in range(g0, g1 + 1):
            e = entries[si]
            f0 = e.start // shift_units
            f1 = min(int(round(e.end / shift_units)), total_frames)
            if f1 <= f0:
                continue
            out[f0:f1, :qdim] = _ans(e.label)[None, :]
            if not add_frame_features:
                continue
            n = f1 - f0
            fwd = (np.arange(n, dtype=np.float32) + 0.5) / n
            out[f0:f1, qdim + 0] = fwd
            out[f0:f1, qdim + 1] = 1.0 - fwd
            if e.state is not None:
                out[f0:f1, qdim + 2] = (e.state - 1) / float(NUM_STATES)
            out[f0:f1, qdim + 3] = (e.end - e.start) / HTK_UNITS_PER_SEC
            pn = max(pf1 - pf0, 1)
            pfwd = (np.arange(f0 - pf0, f1 - pf0, dtype=np.float32) + 0.5) / pn
            out[f0:f1, qdim + 4] = pfwd
            out[f0:f1, qdim + 5] = 1.0 - pfwd
            out[f0:f1, qdim + 6] = phone_dur_sec
            out[f0:f1, qdim + 7] = (np.arange(f0 - pf0, f1 - pf0) + 0.5) * shift_sec
            out[f0:f1, qdim + 8] = (pf1 - pf0 - np.arange(f0 - pf0, f1 - pf0) - 0.5) * shift_sec

    return out


def binarize_label_file(
    path: str,
    questions: QuestionSet,
    shift_sec: float = 0.005,
    add_frame_features: bool = True,
) -> np.ndarray:
    return binarize_labels(
        parse_label_file(path), questions, shift_sec, add_frame_features
    )
