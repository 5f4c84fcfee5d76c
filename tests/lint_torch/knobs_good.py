"""hvdlint-torch fixture: registry-clean knob access — zero findings
expected."""

import os

from horovod_tpu_torch.config import knobs


def bucket_bytes():
    return knobs.get("HOROVOD_GRADIENT_BUCKET_BYTES")


def launcher_env(env, port):
    # writing a child's environment is the launcher's job
    env["MASTER_PORT"] = str(port)
    env["HOROVOD_GRADIENT_COMPRESSION"] = "none"
    return env


def rank_from_env():
    # torch.distributed's variables are outside the registry
    return int(os.environ.get("RANK", "0"))
