"""paddle_tpu_torch.testing — test-support utilities that ship in the
package because production code cooperates with them: the serving engine
carries named fault-injection hook sites that ``faultinject.FaultPlan``
drives, as a chaos test or a staging deployment would. After
``paddle_tpu/testing``.

The harness itself uses numpy and the standard library only.
"""
from .faultinject import POINTS, FaultPlan, InjectedFault, plan_from_flags

__all__ = ["FaultPlan", "InjectedFault", "POINTS", "plan_from_flags"]
