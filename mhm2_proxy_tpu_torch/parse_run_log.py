"""Per-module wall-time table from a run log (reference src/mhm2_parse_run_log.pl).

The reference's Perl tool extracts per-module times from mhm2.log into a
table (mhm2_parse_run_log.pl:11-31). Our pipeline emits the same information
as `[module] <name> <secs>s` lines (main.py; a multi-process run's line adds
`(min <s> max <s> over <n> procs)` to the average); this tool tabulates them,
with per-module totals and the share of overall logged time.

Usage: python -m mhm2_proxy_tpu_torch.parse_run_log <out_dir>/mhm2_torch.log
"""

from __future__ import annotations

import re
import sys

_MODULE_RE = re.compile(r"\[module\] (\S+(?: k=\d+)?) ([\d.]+)s")


def parse_modules(lines) -> list[tuple[str, float]]:
    """Ordered (module, seconds) entries from `[module]` log lines."""
    out = []
    for line in lines:
        m = _MODULE_RE.search(line)
        if m:
            out.append((m.group(1), float(m.group(2))))
    return out


def format_table(entries: list[tuple[str, float]]) -> str:
    if not entries:
        return "no [module] lines found"
    total = sum(t for _, t in entries)
    width = max(len(name) for name, _ in entries + [("TOTAL", 0)])
    rows = [f"{'module':<{width}}  {'secs':>9}  {'share':>6}"]
    for name, secs in entries:
        rows.append(f"{name:<{width}}  {secs:>9.2f}  {100 * secs / total:>5.1f}%")
    rows.append(f"{'TOTAL':<{width}}  {total:>9.2f}  100.0%")
    return "\n".join(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[-1], file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        print(format_table(parse_modules(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
