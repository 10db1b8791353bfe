"""BIF (Bayesian Interchange Format) reader/writer.

From-scratch regex-based parser replacing the reference's pyparsing grammar
(``pgmpy/readwrite/BIF.py:34-731``) — one pass over the
text, fast enough for MUNIN (1041 variables) without worker pools.  Parent
configurations are placed by their parsed state tuple, not line order, so
any BIF row ordering loads correctly.
"""

import gzip
import re

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD

# variable bodies contain one level of nested braces (the state list)
_VARIABLE_RE = re.compile(
    r"variable\s+(?P<name>[^\s{]+)\s*\{(?P<body>(?:[^{}]|\{[^{}]*\})*)\}", re.DOTALL
)
_TYPE_RE = re.compile(
    r"type\s+discrete\s*\[\s*(?P<card>\d+)\s*\]\s*\{(?P<states>[^}]*)\}", re.DOTALL
)
_PROB_RE = re.compile(
    r"probability\s*\(\s*(?P<child>[^|)]+?)\s*(?:\|\s*(?P<parents>[^)]*))?\)\s*"
    r"\{(?P<body>[^}]*)\}",
    re.DOTALL,
)
_ROW_RE = re.compile(r"\(\s*(?P<config>[^)]*)\)\s*(?P<values>[^;]*);")
_TABLE_RE = re.compile(r"table\s+(?P<values>[^;]*);")
_DEFAULT_RE = re.compile(r"default\s+(?P<values>[^;]*);")
_NETWORK_RE = re.compile(r"network\s+(?P<name>[^\s{]+)\s*\{")
_PROPERTY_RE = re.compile(r"property\s+(?P<text>[^;]*);")


def open_text(path, mode="r"):
    """``open(path, mode)``, through gzip when ``path`` ends in ``.gz`` (text
    modes as text, binary modes as bytes): every reader and writer of this
    package takes ``.gz`` paths this way."""
    if str(path).endswith(".gz"):
        return gzip.open(path, mode if "b" in mode else mode + "t")
    return open(path, mode)


def _split_csv(text):
    return [t.strip() for t in text.split(",") if t.strip()]


class BIFReader:
    """Parse a .bif / .bif.gz file or string into a DiscreteBayesianNetwork."""

    def __init__(self, path=None, string=None, include_properties=False, n_jobs=1):
        self.include_properties = include_properties
        if path is not None:
            with open_text(path) as f:
                self.network = f.read()
        elif string is not None:
            self.network = string
        else:
            raise ValueError("Must specify either path or string")

        net_match = _NETWORK_RE.search(self.network)
        self.network_name = (
            net_match.group("name").strip('"') if net_match else "unknown"
        )

        self.variable_states = {}
        self.variable_cards = {}
        self.variable_names = []
        self.variable_properties = {}
        for match in _VARIABLE_RE.finditer(self.network):
            name = match.group("name").strip()
            body = match.group("body")
            tmatch = _TYPE_RE.search(body)
            if tmatch is None:
                continue
            states = _split_csv(tmatch.group("states"))
            card = int(tmatch.group("card"))
            if len(states) != card:
                raise ValueError(
                    f"Variable {name}: cardinality {card} != {len(states)} states"
                )
            self.variable_names.append(name)
            self.variable_states[name] = states
            self.variable_cards[name] = card
            self.variable_properties[name] = [
                p.group("text").strip() for p in _PROPERTY_RE.finditer(body)
            ]

        self.variable_parents = {}
        self.tables = {}
        for match in _PROB_RE.finditer(self.network):
            child = match.group("child").strip()
            parents = _split_csv(match.group("parents") or "")
            body = match.group("body")
            self.variable_parents[child] = parents
            card = self.variable_cards[child]
            if parents:
                parent_cards = [self.variable_cards[p] for p in parents]
                n_cols = int(np.prod(parent_cards))
                values = np.zeros((card, n_cols))
                state_index = [
                    {s: i for i, s in enumerate(self.variable_states[p])}
                    for p in parents
                ]
                # row-major strides for the parent-config ravel (pure-int
                # arithmetic: np.ravel_multi_index per row costs ~10x more
                # on MUNIN's ~80k rows)
                strides = [1] * len(parents)
                for i in range(len(parents) - 2, -1, -1):
                    strides[i] = strides[i + 1] * parent_cards[i + 1]
                explicit = np.zeros(n_cols, dtype=bool)
                for row in _ROW_RE.finditer(body):
                    idx = 0
                    for i, s in enumerate(row.group("config").split(",")):
                        idx += strides[i] * state_index[i][s.strip()]
                    values[:, idx] = np.fromstring(row.group("values"), sep=",")
                    explicit[idx] = True
                if not explicit.all():
                    # `default <values>;` fills every parent configuration not
                    # given an explicit row (ref BIF.py:160,287 accepts the
                    # keyword; the BIF spec gives it these fill semantics).
                    dmatch = _DEFAULT_RE.search(body)
                    # some files use a flat `table` row even with parents; the
                    # reference reshapes C-order — child slowest, last parent
                    # fastest (ref BIF.py:287-294).
                    tmatch = _TABLE_RE.search(body)
                    if dmatch:
                        default_col = [
                            float(v) for v in _split_csv(dmatch.group("values"))
                        ]
                        values[:, ~explicit] = np.asarray(default_col)[:, None]
                    elif tmatch:
                        flat = [float(v) for v in _split_csv(tmatch.group("values"))]
                        values = np.asarray(flat).reshape(card, n_cols)
                self.tables[child] = values
            else:
                tmatch = _TABLE_RE.search(body)
                values = np.asarray(
                    [float(v) for v in _split_csv(tmatch.group("values"))]
                ).reshape(card, 1)
                self.tables[child] = values

    def get_variable_grammar(self):
        """The variable-block grammar.  The reference builds a pyparsing
        expression (BIF.py:107); this parser is regex-based, so the compiled
        variable pattern is the grammar object."""
        return _VARIABLE_RE

    def get_probability_grammar(self):
        """The probability-block grammar (regex analog of BIF.py:136)."""
        return _PROB_RE

    def variable_block(self):
        """Yield the raw text of each ``variable`` block (BIF.py:165)."""
        for match in _VARIABLE_RE.finditer(self.network):
            yield match.group(0)

    def probability_block(self):
        """Yield the raw text of each ``probability`` block (BIF.py:171)."""
        for match in _PROB_RE.finditer(self.network):
            yield match.group(0)

    def get_variables(self):
        return list(self.variable_names)

    def get_states(self):
        return dict(self.variable_states)

    def get_parents(self):
        return dict(self.variable_parents)

    def get_values(self):
        return dict(self.tables)

    def get_edges(self):
        return [
            [parent, child]
            for child, parents in self.variable_parents.items()
            for parent in parents
        ]

    def get_network_name(self):
        return self.network_name

    def get_property(self):
        """Per-variable `property` lines (ref BIF.py:238-258)."""
        return dict(self.variable_properties)

    def get_model(self, state_name_type=str):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        model = DiscreteBayesianNetwork()
        model.add_nodes_from(self.variable_names)
        model.add_edges_from(self.get_edges())
        model.name = self.network_name
        if self.include_properties:
            # `prop = value` lines become node attributes (ref BIF.py:405-411)
            for node, props in self.variable_properties.items():
                for prop in props:
                    if "=" in prop:
                        prop_name, prop_value = (t.strip() for t in prop.split("=", 1))
                        model.nodes[node][prop_name] = prop_value

        specs = []
        for var in self.variable_names:
            parents = self.variable_parents.get(var, [])
            state_names = {
                v: [state_name_type(s) for s in self.variable_states[v]]
                for v in [var] + parents
            }
            specs.append(
                (
                    var,
                    self.variable_cards[var],
                    self.tables[var],
                    parents or None,
                    [self.variable_cards[p] for p in parents] or None,
                    state_names,
                )
            )
        # one device transfer for the whole model
        model.add_cpds(*TabularCPD.batch_build(specs))
        return model


class _WriterIntrospection:
    """Shared model-introspection surface for writers (the reference's
    writers each expose these builders, e.g. ref BIF.py:470-651)."""

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
        return {
            str(v): np.asarray(self.model.get_cpds(v).get_values())
            for v in self.model.nodes()
        }


class BIFWriter(_WriterIntrospection):
    """Serialize a DiscreteBayesianNetwork to BIF text."""

    def __init__(self, model):
        model.check_model()
        self.model = model

    def __str__(self):
        return self.get_string()

    def BIF_templates(self):
        """String templates describing the emitted BIF dialect, in the same
        6-tuple contract as the reference (BIF.py:458): network, variable,
        property, flat-table probability, conditional probability block,
        conditional probability row."""
        from string import Template

        network_template = Template("network $name {\n}\n")
        variable_template = Template(
            "variable $name {\n"
            "  type discrete [ $no_of_states ] { $states };\n"
            "$properties}\n"
        )
        property_template = Template("  property $prop ;\n")
        probability_template = Template(
            "probability ( $variable_$separator_$parents ) {\n  table $values;\n}\n"
        )
        conditional_probability_template_total = Template(
            "probability ( $variable_$separator_$parents ) {\n$values\n}\n"
        )
        conditional_probability_template = Template("  ( $state ) $values;")
        return (
            network_template,
            variable_template,
            property_template,
            probability_template,
            conditional_probability_template_total,
            conditional_probability_template,
        )

    def get_string(self):
        (
            network_template,
            variable_template,
            property_template,
            probability_template,
            conditional_total_template,
            conditional_row_template,
        ) = self.BIF_templates()
        model = self.model
        name = getattr(model, "name", None) or "unknown"
        out = [network_template.substitute(name=name)]
        for var in model.nodes():
            cpd = model.get_cpds(var)
            states = ", ".join(str(s) for s in cpd.state_names[var])
            # node attributes persist as `property name = value ;` lines
            # (ref BIF.py:470,514-519,625-651)
            props = "".join(
                property_template.substitute(prop=f"{prop} = {val}")
                for prop, val in sorted(model.nodes[var].items())
                if val is not None
            )
            out.append(
                variable_template.substitute(
                    name=var,
                    no_of_states=cpd.variable_card,
                    states=states,
                    properties=props,
                )
            )
        for var in model.nodes():
            cpd = model.get_cpds(var)
            parents = cpd.variables[1:]
            values = cpd.get_values()
            if not parents:
                table = ", ".join(repr(float(v)) for v in values[:, 0])
                out.append(
                    probability_template.substitute(
                        variable_=var, separator_="", parents="", values=table
                    )
                )
            else:
                parent_cards = [len(cpd.state_names[p]) for p in parents]
                header = ", ".join(str(p) for p in parents)
                rows = []
                for col, config in enumerate(np.ndindex(*parent_cards)):
                    config_names = ", ".join(
                        str(cpd.state_names[p][i]) for p, i in zip(parents, config)
                    )
                    vals = ", ".join(repr(float(v)) for v in values[:, col])
                    rows.append(
                        conditional_row_template.substitute(
                            state=config_names, values=vals
                        )
                    )
                out.append(
                    conditional_total_template.substitute(
                        variable_=var,
                        separator_=" | ",
                        parents=header,
                        values="\n".join(rows),
                    )
                )
        return "".join(out)

    def write_bif(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(self.get_string())
