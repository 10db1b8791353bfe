"""XDSL (GeNIe/SMILE) reader/writer.

Port of ``pgmpy_tpu/readwrite/xdsl.py``; parity: the reference pgmpy's
``pgmpy/readwrite/XDSL.py``.  ``<probabilities>``
lists child-state fastest per parent configuration (Fortran order into the
CPD matrix), parents in ``<parents>`` order with the last parent cycling
fastest.
"""

from xml.dom import minidom
from xml.etree import ElementTree as etree

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.readwrite.bif import open_text


class XDSLReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path, "rb") as f:
                self.root = etree.parse(f).getroot()
        elif string is not None:
            self.root = etree.fromstring(string)
        else:
            raise ValueError("Must specify either path or string")
        self.network_name = self.root.get("id", "unknown")
        self.nodes_el = self.root.find("nodes")

        self.variables = []
        self.variable_states = {}
        self.variable_parents = {}
        self.tables = {}
        for cpt in self.nodes_el.findall("cpt"):
            var = cpt.get("id")
            states = [s.get("id") for s in cpt.findall("state")]
            parents_el = cpt.find("parents")
            parents = parents_el.text.split() if parents_el is not None else []
            probs = np.asarray(
                list(map(float, cpt.find("probabilities").text.split()))
            )
            card = len(states)
            self.variables.append(var)
            self.variable_states[var] = states
            self.variable_parents[var] = parents
            self.tables[var] = probs.reshape((card, probs.size // card), order="F")

    def get_variables(self):
        return list(self.variables)

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

    def get_model(self, state_name_type=str):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        model = DiscreteBayesianNetwork()
        model.add_nodes_from(self.variables)
        model.add_edges_from(self.get_edges())
        model.name = self.network_name

        cpds = []
        for var in self.variables:
            parents = self.variable_parents[var]
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


class XDSLWriter:
    def get_variables(self):
        return sorted(map(str, self.model.nodes()), key=str)

    def get_cpds(self):
        import numpy as np

        return {
            str(v): np.asarray(self.model.get_cpds(v).get_values())
            for v in self.model.nodes()
        }
    def __init__(self, model, network_id="network", encoding="utf-8", prettyprint=True):
        model.check_model()
        self.model = model
        self.encoding = encoding
        self.prettyprint = prettyprint

        self.xml = etree.Element(
            "smile",
            attrib={
                "version": "1.0",
                "id": getattr(model, "name", None) or network_id,
                "numsamples": "10000",
                "discsamples": "10000",
            },
        )
        nodes = etree.SubElement(self.xml, "nodes")
        import networkx as nx

        for var in nx.topological_sort(model):
            cpd = model.get_cpds(var)
            cpt = etree.SubElement(nodes, "cpt", attrib={"id": str(var)})
            for state in cpd.state_names[var]:
                etree.SubElement(cpt, "state", attrib={"id": str(state)})
            parents = cpd.variables[1:]
            if parents:
                etree.SubElement(cpt, "parents").text = " ".join(map(str, parents))
            values = cpd.get_values()
            etree.SubElement(cpt, "probabilities").text = " ".join(
                repr(float(v)) for v in values.ravel(order="F")
            )

    def __str__(self):
        string = etree.tostring(self.xml, encoding=self.encoding)
        if self.prettyprint:
            return minidom.parseString(string).toprettyxml(indent="  ")
        return string.decode(self.encoding)

    def write_xdsl(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(str(self))
