r"""
Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers of the correctness check beside
their limits. With no card, fewer cards than the cell asks for, or JAX or
the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""
import time

T_START = time.time()  # noqa: E402  (set-up is timed from process start)

import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    try:
        result = harness.run(argv, t_start=T_START)
    except harness.Refused as why:
        print(f"portbench: refused: {why}", file=sys.stderr, flush=True)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run's process holds {found}: the port must "
              "not load JAX or the JAX package", file=sys.stderr, flush=True)
        return 4
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
