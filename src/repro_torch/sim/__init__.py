"""Request-level data-plane simulator (digital twin), batched over the
fleet. Port of ``repro.sim``: the state layout and action decode, the
interval advance through the K3 ``queue_advance`` kernel, request-grade
metrics, the scenario library and the closed-loop harness."""
from repro_torch.sim.harness import eval_fleet, sim_observe, simulate_fleet
from repro_torch.sim.metrics import (hist_percentile, summarize,
                                     warn_if_censored)
from repro_torch.sim.scenarios import SCENARIOS, make_scenario
from repro_torch.sim.state import (SimParams, SimState, action_caps,
                                   effective_queue_cap, sim_init,
                                   spread_arrivals)
from repro_torch.sim.step import (sim_interval, sim_interval_agent,
                                  sim_interval_ref)

__all__ = [
    "SCENARIOS", "SimParams", "SimState", "action_caps",
    "effective_queue_cap", "eval_fleet", "hist_percentile", "make_scenario",
    "sim_init", "sim_interval", "sim_interval_agent", "sim_interval_ref",
    "sim_observe", "simulate_fleet", "spread_arrivals", "summarize",
    "warn_if_censored",
]
