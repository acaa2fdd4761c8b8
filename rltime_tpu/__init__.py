"""rltime_tpu — an accelerator-resident actor-learner RL framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference framework `opherlieber/rltime` (see SURVEY.md; the reference
mount was empty this round, so parity claims cite SURVEY.md sections and
BASELINE.json rather than reference file:line).

Architecture (SURVEY.md §7): three planes —
  * host plane: vectorized env engines (numpy / C++ batched steppers),
  * device plane: replay storage, sum-tree prioritized sampling, n-step
    returns, Q-losses, optimizer — one jitted update step, zero host
    round-trips,
  * mesh plane: `jax.sharding.Mesh` ('data','model') with shard_map /
    pjit for sharded replay + data-parallel learners (Ape-X topology).
"""

__version__ = "0.1.0"
