"""MET fixture (the port's registry): ENGINE metric-name discipline.

Seeded violations: undeclared phase and counter names, a computed
(non-literal) name, and near-misses of the port's launch counters.  Legal
shapes alongside: declared names, and an ad-hoc PhaseTimers instance (not
the ENGINE registry, so out of MET scope by design).
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

from spgemm_tpu_torch.utils.timers import ENGINE as timers


def bad_phase(x):
    with timers.phase("made_up_phase"):  # MET: undeclared phase name
        return x


def bad_counter():
    timers.incr("made_up_counter")  # MET: undeclared counter name


def bad_dynamic(name):
    timers.record(name, 0.5)  # MET: computed metric name


def bad_launch_choice(no_mod):
    # MET: computed metric name -- a conditional picks between two
    # declared counters, but the spelled name is not a literal
    timers.incr("launches_numeric_round_no_mod" if no_mod else "launches_numeric_round")


def legal_declared(x):
    with timers.phase("plan"):  # legal: declared phase
        timers.incr("plan_cache_hits")  # legal: declared counter
        return x


def legal_local_instance():
    from spgemm_tpu_torch.utils.timers import PhaseTimers

    t = PhaseTimers()
    with t.phase("driver-local"):  # legal: not the ENGINE registry
        pass


def bad_launch_names():
    # the kernel wrappers' launch counters: a singular near-miss and the
    # JAX package's dispatch counter (the port counts launches per kernel)
    timers.incr("launch_numeric_round")  # MET: undeclared launch counter
    timers.incr("dispatches")  # MET: undeclared JAX-only counter


def legal_launch_names():
    timers.incr("launches_numeric_round")  # legal: declared launch counter
    timers.incr("launches_field_fold")  # legal: declared launch counter


def bad_warm_layer_names():
    timers.incr("warm_hit")  # MET: undeclared warm counter
    with timers.phase("warm_loading"):  # MET: undeclared warm phase
        pass


def legal_warm_names(x):
    with timers.phase("warm_load"):  # legal: declared warm phase
        timers.incr("warm_hits")  # legal: declared warm counter
        return x


def bad_dcn_names():
    with timers.phase("dcn_chains"):  # MET: undeclared dcn phase
        timers.incr("dcn_chunk")  # MET: undeclared dcn counter


def legal_dcn_names():
    with timers.phase("dcn_chain"):  # legal: declared dcn phase
        timers.incr("dcn_chunks")  # legal: declared dcn counter
