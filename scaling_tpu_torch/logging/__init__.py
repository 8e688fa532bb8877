"""Run logging (counterpart of scaling_tpu/logging/)."""

from .logger import Logger, LoggerConfig

__all__ = ["Logger", "LoggerConfig"]
