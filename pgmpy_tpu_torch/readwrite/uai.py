"""UAI competition format reader/writer (MARKOV / BAYES).

Port of ``pgmpy_tpu/readwrite/uai.py``; parity: the reference pgmpy's
``pgmpy/readwrite/UAI.py``, byte-layout compatible
with the reference's writer so files interoperate in both directions:

- variable indices are assigned in ``(cardinality-string, name)`` sort
  order (ref ``UAI.py:341-346`` sorts ``domain.items()`` by value then key);
- BAYES function scopes list the REVERSED evidence followed by the child
  (ref ``UAI.py:417``: ``cpd.variables[:0:-1]``);
- BAYES tables are ``cpd.values.ravel()`` — child varies SLOWEST, the
  original (un-reversed) evidence order C-major after it (ref
  ``UAI.py:455-460``).  This is self-consistent but NOT the standard UAI
  entry order for the written scope.

Divergence (deliberate): the reference READER recovers each CPD's evidence
order from ``model.predecessors``, whose order comes from a ``set`` of
edges (ref ``UAI.py:172-199``) — under hash randomization its own
round-trip silently transposes CPDs (reproducible with
``PYTHONHASHSEED=4``).  Our reader derives the evidence order
deterministically from the function scope itself (reverse of the scope's
parent prefix), which is what the reference's writer meant and what its
reader produces on a lucky hash order.
"""

import re

import numpy as np

from pgmpy_tpu_torch.config import to_numpy
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor
from pgmpy_tpu_torch.readwrite.bif import open_text


class UAIReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path) as f:
                self.network = f.read()
        elif string is not None:
            self.network = string
        else:
            raise ValueError("Must specify either path or string")

        self._token_grammar = re.compile(r"\S+")
        tokens = self._token_grammar.findall(self.network)
        pos = 0
        self.network_type = tokens[pos]; pos += 1
        n_vars = int(tokens[pos]); pos += 1
        self.domain = [int(tokens[pos + i]) for i in range(n_vars)]; pos += n_vars
        n_funcs = int(tokens[pos]); pos += 1
        self.scopes = []
        for _ in range(n_funcs):
            size = int(tokens[pos]); pos += 1
            self.scopes.append([int(tokens[pos + i]) for i in range(size)])
            pos += size
        self.table_values = []
        for scope in self.scopes:
            n_entries = int(tokens[pos]); pos += 1
            self.table_values.append(
                [float(tokens[pos + i]) for i in range(n_entries)]
            )
            pos += n_entries

        self.variables = [f"var_{i}" for i in range(n_vars)]
        self.edges = self.get_edges()
        self.tables = self.get_tables()

    def get_grammar(self):
        """The UAI token grammar.  The reference builds a pyparsing
        expression (UAI.py:63); the format is a flat whitespace-separated
        token stream here, so the token regex is the grammar object."""
        return self._token_grammar

    def get_variables(self):
        return list(self.variables)

    def get_network_type(self):
        return self.network_type

    def get_domain(self):
        return {f"var_{i}": str(c) for i, c in enumerate(self.domain)}

    def get_edges(self):
        edges = set()
        for scope in self.scopes:
            if self.network_type == "BAYES":
                child = scope[-1]
                for parent in scope[:-1]:
                    edges.add((f"var_{parent}", f"var_{child}"))
            else:
                for i in range(len(scope)):
                    for j in range(i + 1, len(scope)):
                        edges.add((f"var_{scope[i]}", f"var_{scope[j]}"))
        return edges

    def get_tables(self):
        tables = []
        for scope, values in zip(self.scopes, self.table_values):
            if self.network_type == "BAYES":
                tables.append((f"var_{scope[-1]}", [str(v) for v in values]))
            else:
                tables.append(
                    ([f"var_{i}" for i in scope], [str(v) for v in values])
                )
        return tables

    def get_model(self):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
        from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork

        if self.network_type == "BAYES":
            from pgmpy_tpu_torch.factors.cpd import TabularCPD

            model = DiscreteBayesianNetwork()
            model.add_nodes_from(self.variables)
            model.add_edges_from(sorted(self.edges))
            cpds = []
            for scope, values in zip(self.scopes, self.table_values):
                child = scope[-1]
                # scope lists REVERSED evidence then child; table entries
                # are child-major over the ORIGINAL evidence order
                parents = list(reversed(scope[:-1]))
                child_card = self.domain[child]
                arr = np.asarray(values).reshape(child_card, -1)
                cpds.append(
                    TabularCPD(
                        f"var_{child}",
                        child_card,
                        arr,
                        evidence=[f"var_{p}" for p in parents] or None,
                        evidence_card=[self.domain[p] for p in parents] or None,
                    )
                )
            model.add_cpds(*cpds)
            return model
        model = DiscreteMarkovNetwork()
        model.add_nodes_from(self.variables)
        model.add_edges_from(sorted(self.edges))
        factors = []
        for scope, values in zip(self.scopes, self.table_values):
            factors.append(
                DiscreteFactor(
                    [f"var_{i}" for i in scope],
                    [self.domain[i] for i in scope],
                    np.asarray(values),
                )
            )
        model.add_factors(*factors)
        return model


class UAIWriter:
    def __init__(self, model, round_values=None):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork
        from pgmpy_tpu_torch.models.markov_network import DiscreteMarkovNetwork

        self.model = model
        self.round_values = round_values
        if isinstance(model, DiscreteBayesianNetwork):
            self.network_type = "BAYES"
        elif isinstance(model, DiscreteMarkovNetwork):
            self.network_type = "MARKOV"
        else:
            raise TypeError(f"Unsupported model type: {type(model)}")
        model.check_model()

    def get_nodes(self):
        """{variable: cardinality-string} (reference ``get_domain``)."""
        model = self.model
        if self.network_type == "BAYES":
            return {
                str(v): str(model.get_cpds(v).variable_card)
                for v in model.nodes()
            }
        card = model.get_cardinality()
        return {str(v): str(card[v]) for v in model.nodes()}

    def get_domain(self):
        """Reference-name alias of get_nodes (ref UAI.py)."""
        return self.get_nodes()

    def _canonical_variables(self):
        """Variable index order: sorted by (cardinality-string, name) —
        the reference's ``sorted(domain.items(), key=(value, key))``."""
        domain = self.get_nodes()
        return [v for v, _ in sorted(domain.items(), key=lambda x: (x[1], x[0]))]

    def _sorted_cpds(self):
        return sorted(self.model.get_cpds(), key=lambda c: str(c.variable))

    def get_functions(self):
        """Function scopes as variable-index lists (BAYES: reversed
        evidence + child, ref UAI.py:414-424)."""
        var_index = {v: i for i, v in enumerate(self._canonical_variables())}
        if self.network_type == "BAYES":
            return [
                [var_index[str(p)] for p in reversed(cpd.variables[1:])]
                + [var_index[str(cpd.variable)]]
                for cpd in self._sorted_cpds()
            ]
        return [
            [var_index[str(v)] for v in f.variables]
            for f in self.model.get_factors()
        ]

    def get_tables(self):
        """Flat probability tables, one list per function (BAYES:
        ``cpd.values.ravel()`` — child slowest, ref UAI.py:455-460)."""
        if self.network_type == "BAYES":
            return [
                np.asarray(cpd.get_values(), dtype=np.float64).ravel().tolist()
                for cpd in self._sorted_cpds()
            ]
        return [
            to_numpy(f.values).astype(np.float64).ravel().tolist()
            for f in self.model.get_factors()
        ]

    def get_string(self):
        variables = self._canonical_variables()
        domain = self.get_nodes()
        lines = [self.network_type, str(len(variables))]
        lines.append(" ".join(domain[v] for v in variables))
        funcs = self.get_functions()
        tables = self.get_tables()
        lines.append(str(len(funcs)))
        for scope in funcs:
            lines.append(f"{len(scope)} " + " ".join(map(str, scope)))
        lines.append("")
        for values in tables:
            if self.round_values is not None:
                values = np.round(values, self.round_values).tolist()
            lines.append(str(len(values)))
            lines.append(" ".join(repr(float(v)) for v in values))
            lines.append("")
        return "\n".join(lines)

    def __str__(self):
        return self.get_string()

    def write_uai(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(self.get_string())
