"""The persistent compiled-artifact store of the port (the counterpart of
``horovod_tpu/store``): the kernel libraries ``nvcc`` builds, the eager
coordinator's fused plans, the train step's and the serving engine's
kernel manifests, shared by every process that points
``HOROVOD_ARTIFACT_STORE`` at the same directory."""

from horovod_tpu_torch.store.artifact_store import (  # noqa: F401
    ArtifactStore,
    StoreKey,
    adopt_step,
    enabled,
    env_fingerprint,
    from_env,
    mesh_fingerprint,
    program_knob_fingerprint,
    read_entry_headers,
    reset_for_tests,
    step_key_components,
    store_stats,
)

__all__ = [
    "ArtifactStore",
    "StoreKey",
    "adopt_step",
    "enabled",
    "env_fingerprint",
    "from_env",
    "mesh_fingerprint",
    "program_knob_fingerprint",
    "read_entry_headers",
    "reset_for_tests",
    "step_key_components",
    "store_stats",
]
