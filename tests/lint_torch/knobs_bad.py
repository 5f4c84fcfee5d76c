"""hvdlint-torch fixture: knob-registry violations (HVD401). NOT
imported at runtime."""

import os


def bucket_bytes():
    return int(os.environ.get("HOROVOD_GRADIENT_BUCKET_BYTES", "0"))  # HVD401


def compression():
    return os.getenv("HOROVOD_GRADIENT_COMPRESSION")                  # HVD401


def unregistered():
    return os.environ["HOROVOD_TORCH_ONLY_KNOB"]                      # HVD401
