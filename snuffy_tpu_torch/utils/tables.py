"""Tabular console reports (the reference's tabulate tables,
reference utils.py:63-66 `print_table` and utils.py:352-422 `check_layers`
matched/discarded layer audits)."""

from __future__ import annotations

from typing import Dict, Sequence


def print_table(d: Dict, headers=("key", "value")) -> str:
    """Render a dict as a two-column table (printed + returned)."""
    try:
        from tabulate import tabulate

        text = tabulate(list(d.items()), headers=headers, tablefmt="github")
    except ImportError:
        width = max((len(str(k)) for k in d), default=3)
        lines = [f"{str(k):<{width}}  {v}" for k, v in d.items()]
        text = "\n".join(lines)
    print(text)
    return text


def print_layer_audit(matched: Sequence[str], mismatched: Sequence[str],
                      max_rows: int = 20) -> str:
    """Checkpoint-import audit (the check_layers report): counts plus the
    first mismatched paths."""
    summary = {
        "matched layers": len(matched),
        "missing/mismatched": len(mismatched),
    }
    for path in list(mismatched)[:max_rows]:
        summary[f"  missing: {path}"] = ""
    if len(mismatched) > max_rows:
        summary[f"  ... and {len(mismatched) - max_rows} more"] = ""
    return print_table(summary, headers=("layer audit", ""))
