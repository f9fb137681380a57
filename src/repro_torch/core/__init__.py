# The typed GAS runtime surface (see core/runtime.py), as the reference's
# `repro.core` lifts it. Only distinct class and function names are
# lifted, so no submodule attribute is shadowed: `from repro_torch.core
# import serve` keeps returning the `core.serve` module.
from .batch import BlockStructure, GASBatch                      # noqa: F401
from .config import HistoryExecConfig                            # noqa: F401
from .history import Histories, HistoryStore                     # noqa: F401
from .runtime import (GASConfig, GASPlan, GASState, build_plan,  # noqa: F401
                      evaluate_exact, fit, init_state, make_prefetch_step_fn,
                      make_step_fn, predict, train_epoch, train_step)
