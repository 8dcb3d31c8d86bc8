"""Run ``chip_smoke.py`` of several checkouts one after the other on one
machine, and time each one's groups of phases, so that two commits compare
on the same host (a card's host moves the whole script by 10 % and more
from one machine to the next).

    python tools/smoke_same_host.py PARENT_DIR CHANGE_DIR [...] [--out=DIR]

Each checkout's ``chip_smoke.py`` runs from its own root.  Every line of its
output is stamped with the seconds since it started and written to
``DIR/same_host_<base name of the checkout>.log`` (``chiprun_out`` by
default).  A group starts at the first line of its first phase, so a script
without ``[time]`` marks is timed as one with them.  The last line is one
JSON object: for each checkout its exit code, wall seconds and groups.
"""

import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

Line = Tuple[float, str]


def first(lines: List[Line], pred: Callable[[str], bool]) -> Optional[int]:
    return next((i for i, (_, s) in enumerate(lines) if pred(s)), None)


def after_last(lines: List[Line], tag: str) -> Optional[int]:
    idx = [i for i, (_, s) in enumerate(lines) if s.startswith(tag)]
    return idx[-1] + 1 if idx else None


def groups(lines: List[Line]) -> Dict[str, float]:
    """Seconds of each group of phases, in the order ``chip_smoke.py`` runs
    them; a group whose phases did not run (19 in an older script) is left out."""
    def starts(tag):
        return lambda s: s.startswith(tag)

    has_19 = any(s.startswith("[19") for _, s in lines)
    bounds = [("1-2 card and build", 0),
              ("3 kernels", first(lines, starts("[3] "))),
              ("4-9 serving, evaluation, training", first(lines, starts("[4] OFA-Base"))),
              ("10 SegOFA-Huge", first(lines, starts("[10] SegOFA-Huge"))),
              ("11 validate", first(lines, starts("fabricated an ofa_base"))),
              ("12 train CLI", after_last(lines, "[11]")),
              ("13-14 serving surface, image files", first(lines, starts("[14a] "))),
              ("15 training stack", first(lines, starts("[15a]"))),
              ("16a-b options", first(lines, starts("[16a]"))),
              ("17c two-process CLIs", after_last(lines, "[16b]")),
              ("19 the training run's surface", after_last(lines, "[17c]") if has_19 else None),
              ("16c-d prompted serving, generation", first(lines, starts("[16c]"))),
              ("17a-b strategies", first(lines, starts("[17a]"))),
              ("18 model axis", first(lines, starts("[18]"))),
              ("end", first(lines, starts('{"serve"')))]
    bounds = [(name, i) for name, i in bounds if i is not None]
    out = {}
    for (name, i), (_, j) in zip(bounds, bounds[1:]):
        out[name] = round(lines[min(j, len(lines) - 1)][0] - (lines[i][0] if i else 0.0), 1)
    return out


def run(checkout: str, out_dir: str) -> Dict[str, object]:
    name = os.path.basename(os.path.abspath(checkout).rstrip("/"))
    log_path = os.path.join(out_dir, f"same_host_{name}.log")
    lines: List[Line] = []
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=checkout,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                errors="replace")
        for line in proc.stdout:
            t = time.perf_counter() - t0
            lines.append((t, line.rstrip("\n")))
            log.write(f"{t:9.1f} {line}")
        rc = proc.wait()
    wall = round(time.perf_counter() - t0, 1)
    return {"rc": rc, "wall_s": wall, "groups": groups(lines), "log": log_path}


def main(argv: List[str]) -> int:
    out_dir = "chiprun_out"
    dirs = []
    for a in argv:
        if a.startswith("--out="):
            out_dir = a.split("=", 1)[1]
        else:
            dirs.append(a)
    if not dirs:
        sys.exit(__doc__)
    os.makedirs(out_dir, exist_ok=True)
    result = {}
    for d in dirs:
        result[os.path.basename(os.path.abspath(d).rstrip("/"))] = r = run(d, out_dir)
        print(f"{d}: rc {r['rc']}, {r['wall_s']} s; {r['groups']}", flush=True)
    print(json.dumps(result))
    return max(r["rc"] for r in result.values())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
