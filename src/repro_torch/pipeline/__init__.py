"""Parallel, budget-driven compression pipeline (Algorithm 1 as a job graph);
counterpart of ``repro.pipeline``.

The offline compression stage is itself a pipeline problem: per-unit rate
allocation plus an embarrassingly-parallel inner loop.  This package turns
``core.compress`` into exactly that:

* :mod:`jobs` — a **planner** that walks compressible units and emits a job
  graph at column-slice granularity (dense) / channel granularity (conv);
* :mod:`runner` — a **worker pool** executing slice jobs (process-based, on a
  forkserver context) with a content-addressed cache;
* :mod:`allocator` — an **adds-budget allocator** searching per-unit knobs to
  hit a global additions budget at max SNR;
* :mod:`cache` — the content-addressed slice-result store (durable,
  msgpack+crc32, when given a directory);
* :mod:`events` — structured progress events for long-run observability.

``core.compress.compress_model_params`` is a thin serial wrapper over
:func:`run_pipeline`, and ``models.api.compress_model`` passes ``n_workers``/
``budget_adds`` straight through.  Parallel output is bitwise-identical to
serial output regardless of worker count or completion order
(sort-by-job-id reduction), and to the reference's.  A run with a
``run_dir`` records its plans and unit hashes, so a killed run resumes from
its cache (``resume=True``).
"""
from .allocator import allocate_budget, candidate_ladder  # noqa: F401
from .cache import SliceCache  # noqa: F401
from .events import CompressionEvent  # noqa: F401
from .jobs import Planner, SliceJob  # noqa: F401
from .runner import PipelineResult, run_pipeline  # noqa: F401

__all__ = ["run_pipeline", "PipelineResult", "CompressionEvent", "SliceCache",
           "Planner", "SliceJob", "allocate_budget", "candidate_ladder"]
