"""NoisyORCPD: noisy-OR parameterized binary CPD.

Port of ``pgmpy_tpu/factors/noisy_or.py``.  P(variable=True | parents) =
1 - prod over the parents in state True of (1 - p_i): a closed-form table
built on the host, then an ordinary ``TabularCPD``.

Examples
--------
>>> import numpy as np
>>> from pgmpy_tpu_torch.factors import NoisyORCPD
>>> cpd = NoisyORCPD("fever", [0.8, 0.6], evidence=["flu", "cold"])
>>> vals = np.asarray(cpd.get_values(), dtype=float).round(2)
>>> vals[0].tolist()  # P(fever=True | flu,cold in TT/TF/FT/FF order)
[0.92, 0.8, 0.6, 0.0]
"""

import itertools

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD


class NoisyORCPD(TabularCPD):
    def __init__(self, variable, prob_values, evidence):
        if len(prob_values) != len(evidence):
            raise ValueError("Number of prob_values should be same as evidence")
        if any((p < 0) or (p > 1) for p in prob_values):
            raise ValueError("All probability values should be between 0 and 1")
        prob_values = np.asarray(prob_values, dtype=np.float64)
        n = len(evidence)
        # parents are binary with state 0 = True (state names ["True", "False"])
        active = 1 - np.array(list(itertools.product([0, 1], repeat=n)), dtype=np.float64)
        p_true = 1.0 - np.prod(1.0 - active * prob_values, axis=1) if n else np.zeros(1)
        values = np.stack([p_true, 1.0 - p_true])
        state_names = {name: ["True", "False"] for name in [variable, *evidence]}
        super().__init__(
            variable, 2, values, evidence=list(evidence), evidence_card=[2] * n,
            state_names=state_names,
        )
        self.prob_values = prob_values
