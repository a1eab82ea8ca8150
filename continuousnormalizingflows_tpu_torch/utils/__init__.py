"""Data, checkpoints, profiling, serving export and parameter conversion."""

from . import datasets, export, profiling
from .checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from .export import export_logpdf, export_sampler, load_artifact, save_artifact

__all__ = [
    "datasets",
    "profiling",
    "export",
    "save_checkpoint",
    "load_checkpoint",
    "AsyncCheckpointer",
    "export_logpdf",
    "export_sampler",
    "save_artifact",
    "load_artifact",
]
