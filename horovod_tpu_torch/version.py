"""The port's version (the launcher's ``--version``)."""

__version__ = "0.3.0"
