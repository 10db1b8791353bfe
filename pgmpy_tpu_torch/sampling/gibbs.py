"""GibbsSampling: Markov-blanket Gibbs over many chains at once.

Port of ``pgmpy_tpu/sampling/gibbs.py`` (reference:
``pgmpy/sampling/Sampling.py:409-631``, which pre-enumerates an exponential
per-variable kernel table and runs one sequential Python chain).  The local
conditional ``P(v | markov blanket)`` is computed on the fly: for each
blanket factor, fetch the log-potential row of the chains' current
neighbourhood states and sum.  The chains are the batch axis, and every
draw comes from one explicit ``torch.Generator`` per call.  On a card a sweep
is ONE launch of the hand-written kernel of ``csrc/gibbs.cu``
(``ops/gibbs.py``: the variables drawn level by level, no two of one factor
in a level, Philox noise keyed on one draw from the generator per sweep); on
the CPU its plain version, a few torch ops per (variable, blanket factor).
The same seed gives the same chains on the same device; the CPU's and the
GPU's random streams differ.
"""

import networkx as nx
import numpy as np
import torch

from pgmpy_tpu_torch.config import config, to_numpy
from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
from pgmpy_tpu_torch.models.markov_chain import MarkovChain
from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork
from pgmpy_tpu_torch.ops import gibbs as gibbs_ops
from pgmpy_tpu_torch.utils.mathext import seeded_generator


class CompiledGibbs:
    def __init__(self, factors, variables, cards, state_names):
        """factors: list of DiscreteFactor over ``variables``.

        ONE table layout: per (variable, blanket factor) the factor's log
        table with the variable's axis moved LAST, reshaped ``(rows, card)``;
        the chains' neighbourhood states index the row, ``card`` contiguous
        numbers per chain.  The sweep's CSR tables and level schedule
        (``ops.gibbs.GibbsTables``) are built here, once per sampler.  A table is therefore stored once per scope
        variable, whatever its size: the JAX package's second layout (one
        shared flat copy with per-element gathers for tables over 4 M
        elements) traded speed for memory, and a table whose copies did not
        fit this device's memory would not fit as a clique of a junction
        tree either.
        """
        self.variables = list(variables)
        self.var_index = {v: i for i, v in enumerate(self.variables)}
        self.cards = [int(cards[v]) for v in self.variables]
        self.state_names = state_names

        # per variable: [(table (rows, card), other variables' positions,
        # their row strides)], one entry per blanket factor
        self._var_specs = [[] for _ in self.variables]
        for factor in factors:
            vals = to_numpy(factor.values).astype(np.float64)
            logs = np.log(np.maximum(vals, 1e-38))
            scope = [self.var_index[u] for u in factor.variables]
            for pos, i in enumerate(scope):
                others = [k for k in range(vals.ndim) if k != pos]
                card = vals.shape[pos]
                moved = np.transpose(logs, others + [pos]).reshape(-1, card)
                rstrides = []
                acc = 1
                for k in reversed(others):
                    rstrides.append(acc)
                    acc *= vals.shape[k]
                self._var_specs[i].append((
                    torch.as_tensor(moved, dtype=config.DTYPE, device=config.DEVICE),
                    tuple(scope[k] for k in others),
                    tuple(reversed(rstrides)),
                ))
        self._out_dtype = torch.int8 if max(self.cards, default=2) < 128 else torch.int32
        self._tables = gibbs_ops.GibbsTables(self._var_specs, self.cards, self._out_dtype)

    def _conditional_logits(self, states, var_i):
        """log P(var_i = k | rest) up to a constant, for EVERY chain:
        states (d, n) -> (n, card).  ``states`` holds one ROW per variable
        (int64), transposed against the JAX package's ``(n, d)``, so that a
        variable's states over the chains are contiguous."""
        return gibbs_ops.conditional_logits(self._var_specs, self.cards, states, var_i)

    def _sweep(self, codes, gen, out=None, noise=None):
        """One full Gibbs sweep over all variables for every chain: codes
        (n, d) -> (n, d) in the trajectory's type, into ``out`` when given.
        ONE launch of the sweep kernel on a card, the plain version on the
        CPU (``ops/gibbs.py``, where ``noise`` is described)."""
        return gibbs_ops.sweep(self._tables, codes, gen, noise=noise, out=out)

    def _run_chains(self, gen, size, init_states):
        """init_states: (n_chains, d) integer codes.  Returns the
        (size, n_chains, d) trajectory on ``config.DEVICE``, int8 when every
        cardinality fits (a quarter of the memory of int32; upcast before
        flat-index arithmetic), int32 otherwise: each sweep reads the last
        one's states and writes its own straight into the trajectory.
        ``gen`` is advanced in place: a later call with the same generator and
        the last sweep's states continues the run as if it had not been
        interrupted."""
        device = config.DEVICE
        codes = torch.as_tensor(init_states, device=device).to(self._out_dtype).contiguous()
        size = int(size)
        trajectory = torch.empty((size, codes.shape[0], len(self.variables)),
                                 dtype=self._out_dtype, device=device)
        for t in range(size):
            codes = self._sweep(codes, gen, out=trajectory[t])
        return trajectory


class GibbsSampling(MarkovChain):
    """API parity with the reference GibbsSampling (which subclasses
    MarkovChain: sample() here is the Markov-blanket kernel, but the chain
    surface (add_variable/add_transition_model/is_stationarity/
    prob_from_sample) is inherited), plus multi-chain throughput via
    ``sample_chains``.

    Examples
    --------
    >>> from pgmpy_tpu_torch.factors import TabularCPD
    >>> from pgmpy_tpu_torch.models import DiscreteBayesianNetwork
    >>> from pgmpy_tpu_torch.sampling import GibbsSampling
    >>> model = DiscreteBayesianNetwork([("rain", "wet")])
    >>> model.add_cpds(
    ...     TabularCPD("rain", 2, [[0.8], [0.2]]),
    ...     TabularCPD("wet", 2, [[0.9, 0.2], [0.1, 0.8]],
    ...                evidence=["rain"], evidence_card=[2]))
    >>> gibbs = GibbsSampling(model)
    >>> df = gibbs.sample(size=5, seed=0)  # one chain, 5 sweeps
    >>> sorted(df.columns), len(df)
    (['rain', 'wet'], 5)
    >>> chains = gibbs.sample_chains(n_chains=64, size=10, seed=0)
    >>> tuple(chains.shape)  # (sweeps, chains, variables)
    (10, 64, 2)
    """

    def __init__(self, model=None):
        self.state = None
        self.transition_models = {}
        if isinstance(model, DiscreteBayesianNetwork):
            model.check_model()
            factors = [cpd.to_factor() for cpd in model.get_cpds()]
            cards = {v: model.get_cardinality(v) for v in model.nodes()}
            state_names = model.states
            self.variables = list(nx.topological_sort(model))
        elif isinstance(model, DiscreteMarkovNetwork):
            model.check_model()
            factors = list(model.get_factors())
            cards = model.get_cardinality()
            state_names = model.states
            self.variables = list(model.nodes())
        elif model is None:
            self.variables = []
            return
        else:
            raise ValueError(
                f"model must be a DiscreteBayesianNetwork or DiscreteMarkovNetwork. Got {type(model)}"
            )
        self.latents = set(getattr(model, "latents", set()) or set())
        self.cardinalities = {v: int(cards[v]) for v in self.variables}
        self.transition_models = {v: {} for v in self.variables}
        self._compiled = CompiledGibbs(factors, self.variables, cards, state_names)
        self.state_names = state_names

    def random_state(self, n_chains=1, seed=None):
        rng = np.random.default_rng(seed)
        return np.stack(
            [
                rng.integers(0, [self.cardinalities[v] for v in self.variables])
                for _ in range(n_chains)
            ]
        ).astype(np.int32)

    def set_start_state(self, start_state):
        self._start = start_state

    def _init_codes(self, start_state, n_chains, seed):
        if start_state is None:
            return self.random_state(n_chains, seed)
        codes = []
        state_map = dict((var, st) for var, st in start_state)
        for v in self.variables:
            st = state_map[v]
            names = self.state_names[v]
            codes.append(names.index(st) if st in names else int(st))
        return np.tile(np.asarray(codes, dtype=np.int32), (n_chains, 1))

    def sample(self, start_state=None, size=1, seed=None, include_latents=False):
        """A single-chain trajectory of ``size`` sweeps as a DataFrame.
        Latent columns are dropped unless ``include_latents`` (reference
        ``Sampling.py:583-585``)."""
        import pandas as pd

        traj = self.sample_chains(1, size, start_state=start_state, seed=seed)
        df = pd.DataFrame(traj[:, 0, :].cpu().numpy(), columns=self.variables)
        if not include_latents and self.latents:
            df = df.drop(columns=[v for v in self.variables if v in self.latents])
        return df

    def sample_chains(self, n_chains, size, start_state=None, seed=None, thin=1):
        """(size, n_chains, d) integer trajectory of many chains, a tensor on
        ``config.DEVICE``: int8 when every cardinality < 128 (upcast before
        flat-index arithmetic), int32 otherwise."""
        init = self._init_codes(start_state, n_chains, seed)
        traj = self._compiled._run_chains(seeded_generator(seed), int(size), init)
        return traj[::thin]

    def generate_sample(self, start_state=None, size=1, include_latents=False, seed=None):
        """Generator over sweeps (reference ``Sampling.py:587-633``);
        ``include_latents=False`` drops latent variables from each yielded
        assignment."""
        # sample() drops latents itself; ask for the full frame here and
        # filter per include_latents below
        df = self.sample(start_state=start_state, size=size, seed=seed,
                         include_latents=True)
        from pgmpy_tpu_torch.factors.discrete import State

        latents = getattr(self, "latents", set()) or set()
        keep = [
            v for v in self.variables if include_latents or v not in latents
        ]
        for _, row in df.iterrows():
            yield [State(v, int(row[v])) for v in keep]
