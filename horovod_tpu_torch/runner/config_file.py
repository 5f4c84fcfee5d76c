"""YAML config-file support for ``hvdrun-torch`` (the port's copy of
``horovod_tpu/runner/config_file.py``; PyYAML is imported only when a
file is given).

Reference parity: ``horovodrun --config-file`` (reference:
runner/common/util/config_parser.py — section structure
params/autotune/timeline/stall_check/logging; launch.py config-file flag).
Keys set CLI-argument defaults; anything given explicitly on the command
line wins over the file (the reference's ``override_args`` mechanism).
The keys of the launcher flags the port lacks (``params.fusion_threshold_mb``,
``cycle_time_ms``, ``cache_capacity``, the ``autotune``, ``timeline`` and
``metrics`` sections: subsystems not ported yet) are unknown keys and
raise.

Example::

    params:
      hierarchical_allreduce: false
      torus_allreduce: true
    stall_check:
      enabled: false
    logging:
      level: DEBUG
    elastic:
      min_np: 2
      max_np: 8
      slots: 4
      reset_limit: 3
      grace_seconds: 10
    mesh_shape: "4,2"
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Set


def cli_overrides(parser: argparse.ArgumentParser, argv,
                  command) -> Set[str]:
    """Dest names of every option explicitly present in ``argv`` (so the
    config file never overrides an explicit flag — reference
    config_parser.py override_args contract).

    ``command`` is the parsed REMAINDER (the launched program + its args):
    argparse places it contiguously at the end of ``argv``, and its flags
    belong to the launched program, not to hvdrun — they must not count as
    overrides.
    """
    argv = list(argv or [])
    if command:
        argv = argv[:len(argv) - len(command)]
    tokens = set()
    for tok in argv:
        if tok == "--":
            break
        if tok.startswith("-") and "=" in tok:
            tokens.add(tok.split("=", 1)[0])
        elif tok.startswith("-"):
            tokens.add(tok)
    given = set()
    for action in parser._actions:
        for opt in action.option_strings:
            if opt in tokens:
                given.add(action.dest)
            elif not opt.startswith("--") and action.nargs != 0:
                # Short options accept attached values: -Hhost:4.
                if any(t.startswith(opt) and len(t) > len(opt)
                       for t in tokens):
                    given.add(action.dest)
    return given


def _section(config: Dict[str, Any], name: str) -> Dict[str, Any]:
    value = config.get(name)
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise ValueError(
            f"config section {name!r} must be a mapping, got {value!r}")
    return value


class _ConfigApplier:
    """Writes YAML values onto parsed args with the same type coercion the
    CLI path gets (argparse ``type=``), never clobbering explicit flags."""

    def __init__(self, parser: argparse.ArgumentParser, args,
                 overrides: Set[str]):
        self._args = args
        self._overrides = overrides
        self._actions = {a.dest: a for a in parser._actions}

    def set(self, dest: str, value: Any) -> None:
        if value is None or dest in self._overrides:
            return
        action = self._actions.get(dest)
        if action is not None and isinstance(
                action, (argparse._StoreTrueAction,
                         argparse._StoreFalseAction)):
            if not isinstance(value, bool):
                raise ValueError(
                    f"config value for {dest!r}: expected a boolean, "
                    f"got {value!r}")
        elif action is not None and action.type is not None:
            # bool subclasses int — `min_np: true` must not slide
            # through as int(True); reject it like any other wrong type.
            if isinstance(value, bool):
                raise ValueError(
                    f"config value for {dest!r}: expected a "
                    f"{action.type.__name__}, got a boolean")
            if not isinstance(value, action.type):
                try:
                    value = action.type(value)
                except (TypeError, ValueError) as exc:
                    raise ValueError(
                        f"config value for {dest!r}: {value!r} is not a "
                        f"valid {action.type.__name__}") from exc
        elif action is not None:
            # Untyped options are strings on the CLI path; env_from_args
            # and subprocess env both require str values.
            if isinstance(value, bool):
                raise ValueError(
                    f"config value for {dest!r}: expected a string, "
                    f"got {value!r}")
            if not isinstance(value, str):
                value = str(value)
        setattr(self._args, dest, value)


_KNOWN_KEYS = {
    None: {"params", "stall_check", "logging", "elastic", "trace",
           "mesh_shape", "num_proc", "hosts"},
    "params": {"hierarchical_allreduce", "torus_allreduce"},
    "stall_check": {"enabled"},
    "trace": {"enabled", "dir", "profile"},
    "logging": {"level"},
    "elastic": {"min_np", "max_np", "slots", "reset_limit", "grace_seconds",
                "host_discovery_script"},
}


def _check_keys(mapping: Dict[str, Any], section) -> None:
    """A typo'd key must fail loudly, not silently leave a default active."""
    unknown = set(mapping) - _KNOWN_KEYS[section]
    if unknown:
        where = f"section {section!r}" if section else "config file"
        raise ValueError(
            f"unknown key(s) in {where}: {sorted(unknown)}; "
            f"known: {sorted(_KNOWN_KEYS[section])}")


def set_args_from_config(parser: argparse.ArgumentParser, args,
                         config: Dict[str, Any],
                         overrides: Set[str]) -> None:
    """Map the YAML sections onto parsed hvdrun args (file loses to CLI)."""
    apply = _ConfigApplier(parser, args, overrides)
    _check_keys(config, None)
    for name in ("params", "stall_check", "logging", "elastic", "trace"):
        _check_keys(_section(config, name), name)

    params = _section(config, "params")
    for key in ("hierarchical_allreduce", "torus_allreduce"):
        apply.set(key, params.get(key))

    trace_cfg = _section(config, "trace")
    apply.set("trace", trace_cfg.get("enabled"))
    apply.set("trace_dir", trace_cfg.get("dir"))
    apply.set("trace_profile", trace_cfg.get("profile"))

    stall = _section(config, "stall_check")
    enabled = stall.get("enabled")
    if enabled is not None:
        if not isinstance(enabled, bool):
            raise ValueError(
                f"config value for 'stall_check.enabled': expected a "
                f"boolean, got {enabled!r}")
        apply.set("stall_check_disable", not enabled)

    logging_sec = _section(config, "logging")
    apply.set("log_level", logging_sec.get("level"))

    elastic = _section(config, "elastic")
    for key in ("min_np", "max_np", "slots", "reset_limit"):
        apply.set(key, elastic.get(key))
    apply.set("elastic_grace_seconds", elastic.get("grace_seconds"))
    apply.set("host_discovery_script", elastic.get("host_discovery_script"))

    apply.set("mesh_shape", config.get("mesh_shape"))
    apply.set("num_proc", config.get("num_proc"))
    apply.set("hosts", config.get("hosts"))


def load_config_file(path: str) -> Dict[str, Any]:
    import yaml
    with open(path) as f:
        config = yaml.safe_load(f) or {}
    if not isinstance(config, dict):
        raise ValueError(f"config file {path!r} must be a YAML mapping")
    return config
