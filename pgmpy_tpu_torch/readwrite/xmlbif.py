"""XMLBIF v0.3 reader/writer (JavaBayes interchange format).

Port of ``pgmpy_tpu/readwrite/xmlbif.py``; parity: the reference pgmpy's
``pgmpy/readwrite/XMLBIF.py``.  TABLE text lists
probabilities child-state-fastest per parent configuration (Fortran order
into the (card, n_configs) CPD matrix).
"""

from xml.etree import ElementTree as etree

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.readwrite.bif import open_text


class XMLBIFReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path, "rb") as f:
                self.network = etree.parse(f).getroot().find("NETWORK")
        elif string is not None:
            self.network = etree.fromstring(string).find("NETWORK")
        else:
            raise ValueError("Must specify either path or string")
        self.network_name = self.network.find("NAME").text
        self.variables = self.get_variables()
        self.variable_parents = self.get_parents()
        self.edge_list = self.get_edges()
        self.variable_states = self.get_states()
        self.variable_CPD = self.get_values()
        self.variable_property = self.get_property()

    def get_variables(self):
        return [
            variable.find("NAME").text
            for variable in self.network.findall("VARIABLE")
        ]

    def get_states(self):
        return {
            variable.find("NAME").text: [
                outcome.text for outcome in variable.findall("OUTCOME")
            ]
            for variable in self.network.findall("VARIABLE")
        }

    def get_parents(self):
        return {
            definition.find("FOR").text: [
                given.text for given in definition.findall("GIVEN")
            ]
            for definition in self.network.findall("DEFINITION")
        }

    def get_edges(self):
        return [
            [value, key]
            for key in self.variable_parents
            for value in self.variable_parents[key]
        ]

    def get_values(self):
        variable_CPD = {}
        for definition in self.network.findall("DEFINITION"):
            var = definition.find("FOR").text
            table = definition.find("TABLE")
            arr = np.asarray(list(map(float, table.text.split())))
            card = len(self.variable_states[var])
            variable_CPD[var] = arr.reshape((card, arr.size // card), order="F")
        return variable_CPD

    def get_property(self):
        return {
            variable.find("NAME").text: [
                prop.text for prop in variable.findall("PROPERTY")
            ]
            for variable in self.network.findall("VARIABLE")
        }

    def get_model(self, state_name_type=str):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        model = DiscreteBayesianNetwork()
        model.add_nodes_from(self.variables)
        model.add_edges_from(self.edge_list)
        model.name = self.network_name

        tabular_cpds = []
        for var, values in self.variable_CPD.items():
            evidence = self.variable_parents[var]
            state_names = {
                v: list(map(state_name_type, self.variable_states[v]))
                for v in [var] + evidence
            }
            cpd = TabularCPD(
                var,
                len(self.variable_states[var]),
                values,
                evidence=evidence or None,
                evidence_card=[
                    len(self.variable_states[e]) for e in evidence
                ]
                or None,
                state_names=state_names,
            )
            tabular_cpds.append(cpd)
        model.add_cpds(*tabular_cpds)
        return model


class XMLBIFWriter:
    def get_variables(self):
        return sorted(map(str, self.model.nodes()), key=str)

    def get_states(self):
        return {
            str(v): [str(s) for s in self.model.get_cpds(v).state_names[v]]
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

    def get_values(self):
        import numpy as np

        return {
            str(v): np.asarray(self.model.get_cpds(v).get_values())
            for v in self.model.nodes()
        }

    def get_definition(self):
        """{variable: [given parents]} (ref XMLBIF.py writer sections)."""
        return {
            str(v): [str(p) for p in self.model.get_cpds(v).variables[1:]]
            for v in self.model.nodes()
        }
    def __init__(self, model, encoding="utf-8", prettyprint=True):
        model.check_model()
        self.model = model
        self.encoding = encoding
        self.prettyprint = prettyprint

        self.xml = etree.Element("BIF", attrib={"VERSION": "0.3"})
        self.network = etree.SubElement(self.xml, "NETWORK")
        name = getattr(model, "name", None) or "UNTITLED"
        etree.SubElement(self.network, "NAME").text = name

        for var in sorted(model.nodes(), key=str):
            cpd = model.get_cpds(var)
            variable = etree.SubElement(
                self.network, "VARIABLE", attrib={"TYPE": "nature"}
            )
            etree.SubElement(variable, "NAME").text = str(var)
            for state in cpd.state_names[var]:
                etree.SubElement(variable, "OUTCOME").text = str(state)

        for var in sorted(model.nodes(), key=str):
            cpd = model.get_cpds(var)
            definition = etree.SubElement(self.network, "DEFINITION")
            etree.SubElement(definition, "FOR").text = str(var)
            for parent in cpd.variables[1:]:
                etree.SubElement(definition, "GIVEN").text = str(parent)
            values = cpd.get_values()
            etree.SubElement(definition, "TABLE").text = " ".join(
                repr(float(v)) for v in values.ravel(order="F")
            )

    def indent(self, elem, level=0):
        """In-place pretty-print formatter (reference XMLBIF.py:315);
        delegates to the stdlib ElementTree indenter."""
        etree.indent(elem, space="  ", level=level)
        return elem

    def __str__(self):
        if self.prettyprint:
            self.indent(self.xml)
        string = etree.tostring(self.xml, encoding=self.encoding)
        return string.decode(self.encoding)

    def write_xmlbif(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(str(self))
