"""Hugin .net format reader/writer.

Port of ``pgmpy_tpu/readwrite/net.py``; parity: the reference pgmpy's
``pgmpy/readwrite/NET.py`` (pyparsing there; a
single-pass regex parser here).  ``potential ( child | p1 p2 ) { data =
(...); }`` nests parentheses parent-first (first parent slowest), child
state fastest — i.e. the flat numbers fill the CPD matrix in Fortran
order like BIF's table rows.
"""

import re

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.readwrite.bif import open_text

_NODE_RE = re.compile(
    r"node\s+(?P<name>\S+)\s*\{(?P<body>[^}]*)\}", re.DOTALL
)
_STATES_RE = re.compile(r"states\s*=\s*\((?P<states>[^)]*)\)")
_POTENTIAL_RE = re.compile(
    r"potential\s*\(\s*(?P<child>[^|)]+?)\s*(?:\|\s*(?P<parents>[^)]*))?\)\s*"
    r"\{(?P<body>[^}]*)\}",
    re.DOTALL,
)
_DATA_RE = re.compile(r"data\s*=\s*(?P<data>[^;]*);", re.DOTALL)
_NET_NAME_RE = re.compile(r"net\s*\{(?P<body>[^}]*)\}", re.DOTALL)


def _parse_states(text):
    return re.findall(r'"([^"]*)"', text)


class NETReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path) as f:
                self.network = f.read()
        elif string is not None:
            self.network = string
        else:
            raise ValueError("Must specify either path or string")

        self.network_name = "unknown"
        self.variable_states = {}
        self.variable_names = []
        for match in _NODE_RE.finditer(self.network):
            name = match.group("name").strip()
            smatch = _STATES_RE.search(match.group("body"))
            if smatch is None:
                continue
            states = _parse_states(smatch.group("states"))
            self.variable_names.append(name)
            self.variable_states[name] = states

        self.variable_parents = {}
        self.tables = {}
        for match in _POTENTIAL_RE.finditer(self.network):
            child = match.group("child").strip()
            parents = (match.group("parents") or "").split()
            dmatch = _DATA_RE.search(match.group("body"))
            numbers = [float(x) for x in re.findall(r"[-+0-9.eE]+", dmatch.group("data"))]
            card = len(self.variable_states[child])
            n_cols = int(np.prod([len(self.variable_states[p]) for p in parents])) if parents else 1
            # numbers iterate parent configs slowest..fastest with the child
            # state innermost
            values = np.asarray(numbers).reshape(n_cols, card).T
            self.variable_parents[child] = parents
            self.tables[child] = values

    def get_variable_grammar(self):
        """The node-block grammar.  The reference builds pyparsing
        expressions (NET.py:413); here the compiled node regex is the
        grammar object."""
        return _NODE_RE

    def get_probability_grammar(self):
        """The potential-block grammar (regex analog of NET.py:446)."""
        return _POTENTIAL_RE

    def get_variables(self):
        return list(self.variable_names)

    def get_states(self):
        return dict(self.variable_states)

    def get_parents(self):
        return dict(self.variable_parents)

    def get_values(self):
        return dict(self.tables)

    def get_network_name(self):
        return self.network_name

    def get_property(self):
        """NET files carry no per-variable property lines here — empty
        lists per variable, matching the reference's shape."""
        return {var: [] for var in self.variable_names}

    def get_edges(self):
        return [
            [parent, child]
            for child, parents in self.variable_parents.items()
            for parent in parents
        ]

    def get_model(self, state_name_type=str):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        model = DiscreteBayesianNetwork()
        model.add_nodes_from(self.variable_names)
        model.add_edges_from(self.get_edges())
        model.name = self.network_name

        cpds = []
        for var in self.variable_names:
            parents = self.variable_parents.get(var, [])
            state_names = {
                v: [state_name_type(s) for s in self.variable_states[v]]
                for v in [var] + parents
            }
            cpds.append(
                TabularCPD(
                    var,
                    len(self.variable_states[var]),
                    self.tables[var],
                    evidence=parents or None,
                    evidence_card=[len(self.variable_states[p]) for p in parents]
                    or None,
                    state_names=state_names,
                )
            )
        model.add_cpds(*cpds)
        return model


class NETWriter:
    def __init__(self, model):
        model.check_model()
        self.model = model

    def get_variables(self):
        return sorted(map(str, self.model.nodes()), key=str)

    def get_states(self):
        return {
            str(v): [str(s) for s in self.model.get_cpds(v).state_names[v]]
            for v in self.model.nodes()
        }

    def get_parents(self):
        return {
            str(v): [str(p) for p in self.model.get_cpds(v).variables[1:]]
            for v in self.model.nodes()
        }

    def get_properties(self):
        return {
            str(v): [
                f"{k} = {val}" for k, val in sorted(self.model.nodes[v].items())
                if val is not None
            ]
            for v in self.model.nodes()
        }

    def get_cpds(self):
        import numpy as np
        return {
            str(v): np.asarray(self.model.get_cpds(v).get_values())
            for v in self.model.nodes()
        }

    def NET_templates(self):
        """String templates for the emitted NET dialect, in the reference's
        4-tuple contract (NET.py:74): network, node, potential, property."""
        from string import Template

        network_template = Template("net\n{\n}\n")
        node_template = Template("node $name\n{\n  states = ($states);\n$properties}\n")
        potential_template = Template(
            "potential ( $variable_$separator_$parents )\n{\n  data = $values;\n}\n"
        )
        property_template = Template("  $prop;\n")
        return (network_template, node_template, potential_template, property_template)

    def net_cpd(self, var_name):
        """The CPD of ``var_name`` in NET ``data`` syntax: one level of
        parens per parent configuration, child state fastest (NET.py:133)."""
        cpd = self.model.get_cpds(var_name)
        values = cpd.get_values()
        if len(cpd.variables) > 1:
            groups = " ".join(
                "(" + " ".join(repr(float(v)) for v in values[:, c]) + ")"
                for c in range(values.shape[1])
            )
            return f"({groups})"
        return "(" + " ".join(repr(float(v)) for v in values[:, 0]) + ")"

    def get_string(self):
        network_template, node_template, potential_template, _ = self.NET_templates()
        model = self.model
        out = [network_template.substitute()]
        for var in model.nodes():
            cpd = model.get_cpds(var)
            states = " ".join(f'"{s}"' for s in cpd.state_names[var])
            out.append(
                node_template.substitute(name=var, states=states, properties="")
            )
        for var in model.nodes():
            cpd = model.get_cpds(var)
            parents = cpd.variables[1:]
            out.append(
                potential_template.substitute(
                    variable_=var,
                    separator_=" | " if parents else "",
                    parents=" ".join(map(str, parents)),
                    values=self.net_cpd(var),
                )
            )
        return "".join(out)

    def __str__(self):
        return self.get_string()

    def write_net(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(self.get_string())
