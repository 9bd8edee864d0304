"""Memory of test files run one after another in one process, as a pytest-xdist
worker runs them.

    JAX_PLATFORMS=cpu python tools/suite_memory.py tests/a.py tests/b.py::test_x

After each argument it prints the process's resident memory and its peak so
far (MB): what a worker carries into its next file, and what a test needs.
"""

import argparse
import resource

import pytest


def rss_mb():
    with open("/proc/self/status") as f:
        return int(f.read().split("VmRSS:")[1].split()[0]) // 1024


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tests", nargs="+")
    args = ap.parse_args(argv)
    for target in args.tests:
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "not slow", target])
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
        print(f"MEMORY {target} rc={int(rc)} rss_mb={rss_mb()} peak_mb={peak}", flush=True)


if __name__ == "__main__":
    main()
