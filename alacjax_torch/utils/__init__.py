"""Utilities: structured metrics, logging, profiling annotations (the
port's copy of alacjax/utils/, names and behaviour unchanged): torch
profiler stage annotations, per-run structured reports, and a
dependency-free logger."""

from .log import get_logger
from .metrics import StageTimer, StreamReport, stage_annotation

__all__ = ["StreamReport", "StageTimer", "stage_annotation", "get_logger"]
