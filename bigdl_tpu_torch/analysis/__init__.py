"""bigdl_tpu_torch.analysis — graftlint over the port (counterpart of
``bigdl_tpu.analysis``).

AST rules over the port's own idioms:

* :mod:`bigdl_tpu_torch.analysis.concurrency` — CC001..CC003: lock-order
  cycles, unlocked shared writes from thread entry points, bare
  ``acquire()``;
* :mod:`bigdl_tpu_torch.analysis.registry_rules` — RD001..RD008:
  ``BIGDL_*`` env reads outside ``config.py``, metric names outside
  ``obs/names.py``, undocumented/unrendered metrics, mint-shape drift,
  span names outside ``serving/spans.py``, fleet policies.

The JAX package's tracing rules (JX001..JX005) have no counterpart: the
port has no jit to trace (``ROADMAP.md`` queue 3).

CLI: ``python -m bigdl_tpu_torch.analysis.lint`` (default path
``bigdl_tpu_torch``), gated by ``tests/test_torch_port_analysis.py``.
"""

from bigdl_tpu_torch.analysis.core import Finding, Linter

__all__ = ["Finding", "Linter", "run_lint"]


def run_lint(*args, **kwargs):
    """Lazy alias for :func:`bigdl_tpu_torch.analysis.lint.run_lint`
    (imported on demand so ``python -m bigdl_tpu_torch.analysis.lint``
    doesn't import it twice)."""
    from bigdl_tpu_torch.analysis.lint import run_lint as _run

    return _run(*args, **kwargs)
