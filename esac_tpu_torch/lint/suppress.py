"""Suppression comments + the committed findings baseline (counterpart of
``esac_tpu/lint/suppress.py``).

Two escape hatches, with different intents:

- **Inline suppression** -- ``# torch-lint: disable=R6(reason)`` on the
  offending line (or ``disable-file=`` in the first 40 lines for
  whole-file rules).  For reviewed, permanent exceptions: code that is
  sanctioned to break a rule by design.  The directive word is the port's
  own (``torch-lint``), so the JAX package's sweep never sees it.
- **Baseline** (``esac_tpu_torch/lint/baseline.json``, empty) --
  grandfathers pre-existing findings.  Entries match on (rule, path,
  stripped source line) and may carry an ``expires: "YYYY-MM-DD"`` date.

Both hatches can go stale.  Full-tree runs audit them:
:func:`record_usage` collects which directives masked a finding during a
run, and :func:`stale_suppressions` diffs that against every directive
declared in the tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import pathlib
import re

from esac_tpu_torch.lint.findings import Finding

# The directive: "torch-lint: disable=R1,R2(reason ...)" after a '#' --
# comma-separated rule ids, an optional parenthesized reason after each
# (reasons may not contain ')').
_DIRECTIVE = re.compile(
    r"#\s*torch-lint:\s*(?P<kind>disable(?:-file)?)\s*=\s*(?P<rules>[^#]+)"
)
_RULE_HEAD = re.compile(r"\s*(?P<rule>[A-Z]\d+)\s*")
_RULE_SEP = re.compile(r"\s*,")


def _parse_rule_list(spec: str) -> set[str]:
    """Sequential parse of ``R1,R2(reason),R3`` — NOT a global token scan.

    A reason whose closing ')' is missing (it wraps to the next comment
    line) ends the list: rule ids mentioned inside the prose of a reason
    must never widen the suppression.
    """
    rules: set[str] = set()
    pos = 0
    while True:
        m = _RULE_HEAD.match(spec, pos)
        if not m:
            break
        rules.add(m.group("rule"))
        pos = m.end()
        if pos < len(spec) and spec[pos] == "(":
            close = spec.find(")", pos)
            if close == -1:
                break  # reason continues past this line; list ends here
            pos = close + 1
        m = _RULE_SEP.match(spec, pos)
        if not m:
            break
        pos = m.end()
    return rules

# File-level directives must sit in the header, not be buried mid-file.
_FILE_DIRECTIVE_MAX_LINE = 40


def parse_suppressions(source: str) -> tuple[dict[int, set[str]], set[str]]:
    """-> (line -> rules suppressed on that line, rules suppressed file-wide).
    A directive covers its own line only."""
    per_line: dict[int, set[str]] = {}
    per_file: set[str] = set()
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE.search(line)
        if not m:
            continue
        rules = _parse_rule_list(m.group("rules"))
        if m.group("kind") == "disable-file":
            if lineno <= _FILE_DIRECTIVE_MAX_LINE:
                per_file |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return per_line, per_file


# Active usage recorder (None = off).  A set of (path, lineno, rule)
# triples — lineno 0 marks a file-level directive — filled by
# is_suppressed whenever a directive actually masks a finding, so a
# full-tree run can report directives that masked NOTHING (stale).
_USAGE: set[tuple[str, int, str]] | None = None


@contextlib.contextmanager
def record_usage():
    """Collect which suppression directives fire during the enclosed
    lint run; yields the live (path, lineno, rule) set."""
    global _USAGE
    prev, _USAGE = _USAGE, set()
    try:
        yield _USAGE
    finally:
        _USAGE = prev


def note_usage(hits) -> None:
    """Add (path, lineno, rule) hits to the active recorder, if any."""
    if _USAGE is not None:
        _USAGE.update(hits)


def is_suppressed(
    rule: str,
    lineno: int,
    per_line: dict[int, set[str]],
    per_file: set[str],
    path: str | None = None,
) -> bool:
    hit_line = rule in per_line.get(lineno, set())
    hit_file = rule in per_file
    if _USAGE is not None and path is not None:
        if hit_line:
            _USAGE.add((path, lineno, rule))
        if hit_file:
            _USAGE.add((path, 0, rule))
    return hit_file or hit_line


def declared_suppressions(root: pathlib.Path, files=None):
    """Every inline directive in the tree: {(path, lineno, rule)} with
    lineno 0 for file-level directives (the universe the stale sweep
    diffs :func:`record_usage`'s hits against)."""
    from esac_tpu_torch.lint.ast_rules import iter_python_files

    declared: set[tuple[str, int, str]] = set()
    root = pathlib.Path(root)
    rels = list(iter_python_files(root, files))
    for rel in rels:
        try:
            source = (root / rel).read_text()
        except (OSError, UnicodeDecodeError):
            continue
        per_line, per_file = parse_suppressions(source)
        for lineno, rules in per_line.items():
            declared.update((rel, lineno, r) for r in rules)
        declared.update((rel, 0, r) for r in per_file)
    return declared


def stale_suppressions(declared, used) -> list[str]:
    """Human-readable notes for directives that masked nothing this run
    — the violation was fixed (prune the directive) or the rule moved."""
    out = []
    for path, lineno, rule in sorted(declared - set(used)):
        where = f"{path}:{lineno}" if lineno else f"{path} (file-level)"
        out.append(
            f"stale inline suppression ({rule} at {where}): the rule no "
            "longer fires there — remove the directive (a lingering "
            "suppression silently masks the NEXT violation)"
        )
    return out


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    text: str
    expires: str | None = None  # "YYYY-MM-DD"; None = never

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.text)

    def expired(self, today: datetime.date) -> bool:
        if self.expires is None:
            return False
        return datetime.date.fromisoformat(self.expires) < today


class Baseline:
    """The committed grandfather list (esac_tpu_torch/lint/baseline.json)."""

    def __init__(self, entries: list[BaselineEntry]):
        self.entries = entries

    @classmethod
    def load(cls, path: pathlib.Path) -> "Baseline":
        if not path.exists():
            return cls([])
        data = json.loads(path.read_text())
        return cls([BaselineEntry(**e) for e in data.get("entries", [])])

    @classmethod
    def from_findings(cls, findings) -> "Baseline":
        return cls([
            BaselineEntry(rule=f.rule, path=f.path, text=f.text)
            for f in findings
        ])

    def write(self, path: pathlib.Path) -> None:
        data = {
            "comment": "torch-lint grandfathered findings. "
                       "Matching is (rule, path, stripped source line), "
                       "line-number independent.  Do not add entries for "
                       "new code.",
            "entries": [dataclasses.asdict(e) for e in self.entries],
        }
        path.write_text(json.dumps(data, indent=2) + "\n")

    def apply(
        self, findings, today: datetime.date | None = None
    ) -> tuple[list[Finding], list[BaselineEntry]]:
        """-> (findings not masked by the baseline, stale entries).

        A stale entry matched nothing (the violation was fixed — the entry
        should be deleted) or has expired (it masks nothing anymore and its
        finding resurfaces).
        """
        today = today or datetime.date.today()
        live = {e.key(): e for e in self.entries if not e.expired(today)}
        matched: set[tuple[str, str, str]] = set()
        out = []
        for f in findings:
            key = (f.rule, f.path, f.text)
            if key in live:
                matched.add(key)
            else:
                out.append(f)
        stale = [
            e for e in self.entries
            if e.expired(today) or e.key() not in matched
        ]
        return out, stale
