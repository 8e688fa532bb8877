"""The worker script of ``tests/test_torch_runner.py``: the runners under
test launch it as ``python -u -m tests.test_torch_runner_worker
--payload=<base64 JSON>``. It imports the standard library only, so that
it starts in milliseconds, and holds no tests.

Payload ``case``: ``record`` writes ``<dir>/rank_<RANK>.json`` with the
launch environment and the payload and exits 0; ``fail`` exits 3 at once;
``fail_rank0`` exits 3 on rank 0 after 0.3 s while the other ranks sleep
until they are terminated.
"""

import base64
import json
import os
import sys
import time
from pathlib import Path

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_SLOT",
            "LOCAL_WORLD_SIZE", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "SCALING_TPU_CONTROL_DIR",
            "SCALING_TPU_HOST_ID", "SCALING_TPU_NUM_HOSTS", "SCALING_TPU_COORD_EPOCH")


def main() -> int:
    (arg,) = [a for a in sys.argv[1:] if a.startswith("--payload=")]
    payload = json.loads(base64.urlsafe_b64decode(arg[len("--payload="):]).decode())
    rank = int(os.environ["RANK"])
    if payload["case"] == "record":
        Path(payload["dir"], f"rank_{rank}.json").write_text(json.dumps({
            "env": {k: os.environ.get(k) for k in ENV_KEYS}, "payload": payload,
            "argv0": sys.argv[0]}))
        return 0
    if payload["case"] == "fail" or rank == 0:
        time.sleep(0.3 if payload["case"] == "fail_rank0" else 0)
        return 3
    time.sleep(600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
