"""Process state that a port test file leaves as it found it.

Under ``-n 6 --dist loadfile`` every file of a worker shares one process.
Both packages' admission controllers read the process-wide permit-wait
histogram over the window since their last read, and a p95 past 1.5 s moves
the shed ladder to level 3, which rejects default-tenant queries
(``AdmissionController._refresh_signals_locked``). A file whose queries wait
for permits (5 s waits degrade to best effort under a memory limit) and end
without another admit leaves those waits unread: the next file's first query
in that package reads them as overload and is shed. Resetting both
controllers drops the window's base, so the next read starts a new window.

``admission_windows_reset`` is the module fixture that does so before and
after a file; a file takes it with ``from torch_isolation import
admission_windows_reset  # noqa: F401`` and ``pytestmark``'s
``usefixtures``.

``caches_reset`` empties both packages' plan and result caches before and
after a file that queries object-store stubs: the JAX package's cache key
drops a scan's ``io_config`` (ROADMAP C.54), so a plan cached over one
stub's ``gs://data/tbl`` is served to a later file's query of the same URL
through another stub, whose port the first stub no longer answers.
"""

import pytest


def reset_admission_windows() -> None:
    """Both packages' admission controllers fresh: tenants, policy overrides,
    the shed level and the permit-wait window."""
    from daft_tpu.execution import admission as jadm
    from daft_tpu_torch.execution import admission as tadm

    for adm in (jadm, tadm):
        adm.get_controller().reset()


@pytest.fixture(scope="module")
def admission_windows_reset():
    reset_admission_windows()
    yield
    reset_admission_windows()


@pytest.fixture(scope="module")
def caches_reset():
    from daft_tpu import plancache as jpc
    from daft_tpu_torch import plancache as tpc

    jpc.reset_caches()
    tpc.reset_caches()
    yield
    jpc.reset_caches()
    tpc.reset_caches()
