"""MarkovChain: multi-variable Markov chain with per-variable transition
models.

Port of ``pgmpy_tpu/models/markov_chain.py``.  A chain is sequential, so the
sampler is a host loop over time steps; each step draws the next state of
every variable at once on ``config.DEVICE`` (one row gather from the padded
log transition matrices and one argmax against noise that one explicit
``torch.Generator`` drew for the whole trajectory up front).
"""

import numpy as np
import pandas as pd
import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.factors.discrete import State
from pgmpy_tpu_torch.utils.mathext import race_noise, seeded_generator


class MarkovChain:
    """Multi-variable Markov chain with per-variable transition models;
    sampling runs on ``config.DEVICE``.

    Examples
    --------
    >>> from pgmpy_tpu_torch.models import MarkovChain
    >>> chain = MarkovChain(["weather"], [2], start_state=[("weather", 0)])
    >>> chain.add_transition_model("weather",
    ...                            {0: {0: 0.7, 1: 0.3}, 1: {0: 0.3, 1: 0.7}})
    >>> df = chain.sample(size=10, seed=0)
    >>> (list(df.columns), len(df))
    (['weather'], 10)
    >>> bool(chain.is_stationarity(tolerance=0.2))
    True
    """

    def __init__(self, variables=None, card=None, start_state=None):
        if variables is None:
            variables = []
        if card is None:
            card = []
        if not hasattr(variables, "__iter__") or isinstance(variables, str):
            raise ValueError("variables must be a non-string iterable.")
        if not hasattr(card, "__iter__") or isinstance(card, str):
            raise ValueError("card must be a non-string iterable.")
        self.variables = list(variables)
        self.cardinalities = {v: c for v, c in zip(variables, card)}
        self.transition_models = {var: {} for var in variables}
        if start_state is None or self._check_state(start_state):
            self.state = start_state

    def _check_state(self, state):
        try:
            list_, state_vars = map(list, zip(*state))
        except TypeError:
            raise ValueError("Start state must be a list of 2-tuples or a State namedtuple.")
        if not set(self.variables) == set(list_):
            raise ValueError(f"Start state must represent a complete assignment to all variables. Expected variables in state: {list_}, Got: {self.variables}.")
        for var, val in state:
            if val >= self.cardinalities[var]:
                raise ValueError(f"Assignment {val} to {var} invalid.")
        return True

    def set_start_state(self, start_state):
        if start_state is not None:
            if not isinstance(start_state, list):
                raise ValueError("start_state must be a list of State namedtuples")
            # reorder to self.variables order
            state_dict = {var: st for var, st in start_state}
            start_state = [State(var, state_dict[var]) for var in self.variables]
        if start_state is None or self._check_state(start_state):
            self.state = start_state

    def add_variable(self, variable, card=0):
        if variable not in self.variables:
            self.variables.append(variable)
        self.cardinalities[variable] = card
        self.transition_models[variable] = {}

    def add_variables_from(self, variables, cards):
        for var, card in zip(variables, cards):
            self.add_variable(var, card)

    def add_transition_model(self, variable, transition_model):
        """``transition_model``: {from_state: {to_state: prob}} or a 2-D
        array with rows = from-state distributions."""
        if isinstance(transition_model, (np.ndarray, list)):
            arr = np.asarray(transition_model)
            if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
                raise ValueError("Transition model must be a square matrix")
            transition_model = {
                i: {j: float(arr[i, j]) for j in range(arr.shape[1])}
                for i in range(arr.shape[0])
            }
        if not isinstance(transition_model, dict):
            raise ValueError("Transition model must be a dict or 2-D array")
        exp_states = set(range(self.cardinalities[variable]))
        if set(transition_model.keys()) != exp_states:
            raise ValueError("Transitions must be defined for all states of variable")
        for _, transition in transition_model.items():
            if not isinstance(transition, dict):
                raise ValueError("Each transition must be a dict")
            if set(transition.keys()) != exp_states:
                raise ValueError("Transitions must be defined for all states of variable")
            if abs(sum(transition.values()) - 1.0) > 1e-6:
                raise ValueError("Transition probabilities must sum to 1")
        self.transition_models[variable] = transition_model

    def _transition_matrices(self):
        mats = {}
        for var in self.variables:
            card = self.cardinalities[var]
            mat = np.zeros((card, card))
            for i, row in self.transition_models[var].items():
                for j, p in row.items():
                    mat[i, j] = p
            mats[var] = mat
        return mats

    def sample(self, start_state=None, size=1, seed=None):
        """Sample a trajectory of length ``size``: row ``t`` is the state before
        step ``t``, the first row the start state."""
        if start_state is None:
            if self.state is None:
                self.state = self.random_state()
        else:
            self.set_start_state(start_state)

        mats = self._transition_matrices()
        n_vars = len(self.variables)
        max_card = max((self.cardinalities[v] for v in self.variables), default=1)
        # (variable, from-state, to-state), padded to the largest cardinality
        # with -inf so that a padding state is never drawn
        log_mats = np.full((n_vars, max_card, max_card), -np.inf)
        for i, v in enumerate(self.variables):
            card = self.cardinalities[v]
            log_mats[i, :card, :card] = np.log(np.maximum(mats[v], 1e-38))
        log_mats = torch.as_tensor(log_mats, dtype=config.DTYPE, device=config.DEVICE)
        state = torch.as_tensor([st for _, st in self.state], dtype=torch.int64,
                                device=config.DEVICE)
        size = int(size)
        noise = race_noise((size, n_vars, max_card), seeded_generator(seed))
        which = torch.arange(n_vars, device=config.DEVICE)
        states = torch.empty((size, n_vars), dtype=torch.int64, device=config.DEVICE)
        for t in range(size):
            states[t] = state
            state = torch.argmax(log_mats[which, state] - noise[t], dim=-1)
        self.state = [State(var, int(v)) for var, v in zip(self.variables, state.tolist())]
        return pd.DataFrame(states.cpu().numpy().astype(np.int32), columns=self.variables)

    def prob_from_sample(self, state, sample=None, window_size=None):
        """Empirical probability trace of ``state`` across sliding windows."""
        if sample is None:
            sample = self.sample(self.state, size=10000)
        if window_size is None:
            window_size = len(sample) // 100
        indicator = np.ones(len(sample), dtype=bool)
        for var, st in state:
            indicator &= (sample[var] == st).to_numpy()
        probabilities = []
        for i in range(0, len(sample), window_size):
            win = indicator[i : i + window_size]
            probabilities.append(win.mean() if len(win) else 0.0)
        return probabilities

    def generate_sample(self, start_state=None, size=1, seed=None):
        """Generator of successive states."""
        df = self.sample(start_state=start_state, size=size, seed=seed)
        for _, row in df.iterrows():
            yield [State(var, int(row[var])) for var in self.variables]

    def is_stationarity(self, tolerance=0.2, sample=None):
        """Heuristic stationarity check on windowed marginals."""
        keys = self.transition_models.keys()
        return_val = True
        for k in keys:
            # sample trajectory marginal stability for state 0 of each var
            probs = self.prob_from_sample([State(k, 0)], sample=sample)
            if len(probs) >= 2:
                half = len(probs) // 2
                diff = abs(np.mean(probs[:half]) - np.mean(probs[half:]))
                if diff > tolerance:
                    return_val = False
        return return_val

    def random_state(self):
        return [
            State(var, np.random.randint(self.cardinalities[var]))
            for var in self.variables
        ]

    def copy(self):
        markov_chain = MarkovChain(
            variables=list(self.variables),
            card=[self.cardinalities[var] for var in self.variables],
            start_state=self.state,
        )
        for var, tm in self.transition_models.items():
            if tm:
                markov_chain.transition_models[var] = {
                    k: dict(v) for k, v in tm.items()
                }
        return markov_chain
