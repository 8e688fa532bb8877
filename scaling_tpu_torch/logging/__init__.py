"""Run logging (counterpart of scaling_tpu/logging/)."""

from .logger import Logger, LoggerConfig, append_jsonl_line, logger, set_trace_provider

__all__ = ["Logger", "LoggerConfig", "append_jsonl_line", "logger", "set_trace_provider"]
