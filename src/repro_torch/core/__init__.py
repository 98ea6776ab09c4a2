"""RailX core, the port's own copy of ``repro.core``: the paper's
contributions as composable modules.

availability   - Algorithm 2, the Fig. 17 curve, the MLaaS allocation (Fig. 20)
hamiltonian    - rail-ring all-to-all decomposition (Lemma 3.1, SA.1)
topology       - physical architecture + Torus/HyperX/Dragonfly/dim-splitting
routing        - minimal + non-minimal adaptive routing, VC discipline
analytical     - communication-time models (Eqs. 2-13)
cost           - Tables 3/6 cost model
mapping        - 5D parallelism mapping + bandwidth allocation (S5, Table 4)
simulator      - flow-level network simulator (Fig. 14/15)
compiled_flow  - the simulator's CSR engine: tensors on the card, its hot
                 loops in the hand-written kernels of ``kernels/flow``

The pure-Python modules hold no tensors.
"""

from . import analytical, availability, compiled_flow, cost, hamiltonian, mapping, routing, simulator, topology  # noqa: F401
