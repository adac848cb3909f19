"""A child for ``tests/test_torch_supervise.py``'s ChildPool cases.

    python tests/_torch_pool_child.py exit N     # exit with code N
    python tests/_torch_pool_child.py sleep S    # sleep S seconds, exit 0
    python tests/_torch_pool_child.py import     # import the port, exit 0

``import`` shows that a child started from any working directory finds
the ``sparknet_tpu_torch`` package (the pool puts it on ``PYTHONPATH``).
"""

import sys
import time


def main(argv):
    what = argv[1]
    if what == "exit":
        return int(argv[2])
    if what == "sleep":
        time.sleep(float(argv[2]))
        return 0
    if what == "import":
        import sparknet_tpu_torch  # noqa: F401

        return 0
    raise SystemExit(f"unknown mode {what!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv))
