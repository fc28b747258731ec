"""Dynamic recompilation hook (counterpart of
flexflow_tpu/runtime/recompile.py).

`RecompileState` holds a user trigger function, checked after every fit
step, and an alter function that mutates the model when it fires (the
reference's MoE cache swap, an activation or rate change on a node).
Then the program is rebuilt. The port runs the graph eagerly, so what a
rebuild drops is everything its Executor derived from the graph when it
was made: the node order, the input and sink nodes, the fused-softmax
and label-repeat decisions, the remat groups and the node each lowering
is looked up for. `FFModel._recompile` makes a new Executor from the
(altered) graph with the same settings; the weights and the optimizer
state carry over, so the next step runs the altered graph on them.
"""

from __future__ import annotations

from typing import Callable


class RecompileState:
    def __init__(self, trigger_func: Callable[["RecompileState"], bool],
                 alter_func: Callable[["RecompileState"], None], ffmodel):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ffmodel = ffmodel
        self.recompilations = 0
        # the last step's metrics (0-d tensors on the device)
        self.last_metrics = None

    def trigger(self) -> bool:
        return bool(self.trigger_func(self))

    def alter(self):
        self.alter_func(self)
        self.recompilations += 1
        if self.ffmodel._executor is not None:
            self.ffmodel._recompile()


def recompile_on_condition(ffmodel, state: RecompileState) -> bool:
    """Check the trigger and, when it fires, alter and rebuild. Returns
    True when a recompilation happened."""
    if state.trigger():
        state.alter()
        return True
    return False
