#!/usr/bin/env python3
"""Compare the kernel launch counts of two ``chip_smoke.py`` runs, path by
path.

    python3 tools/launch_diff.py OLD.json NEW.json

Each file is a ``chiprun_out/chip_smoke.json`` that ``chip_smoke.py``
wrote.  For every kernel of the ``kernels`` line it compares
``launches_by_path`` (each main-path run's count: a serve mode, a train
run, a command run) over the paths both runs have (a kernel a path does
not list launched 0 times there), lists the paths only one has, and
exits nonzero if a shared path's count differs.  It shows
whether a change to how ops are routed left each existing path launching
exactly what it launched before.
"""

from __future__ import annotations

import json
import sys


def by_path(path: str) -> dict[tuple[str, str], int]:
    rows = json.load(open(path))["kernels"]
    return {(r["name"], p): n for r in rows
            for p, n in (r.get("launches_by_path") or {}).items()}


def main(argv=None) -> int:
    old_path, new_path = (argv or sys.argv[1:])[:2]
    old, new = by_path(old_path), by_path(new_path)
    # a path omits a kernel it launched 0 times there
    old_paths, new_paths = {p for _, p in old}, {p for _, p in new}
    names = sorted({n for n, _ in set(old) | set(new)})
    shared = [(n, p) for n in names for p in sorted(old_paths & new_paths)]
    differ = [(k, old.get(k, 0), new.get(k, 0)) for k in shared
              if old.get(k, 0) != new.get(k, 0)]
    for (name, p), a, b in differ:
        print(f"DIFFERS {name} {p}: {a} -> {b}")
    for p in sorted(new_paths - old_paths):
        print(f"new path {p}")
    for p in sorted(old_paths - new_paths):
        print(f"gone path {p}")
    print(json.dumps({"compared": len(shared), "differ": len(differ),
                      "new_paths": len(new_paths - old_paths),
                      "gone_paths": len(old_paths - new_paths)}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
