"""XBN (Microsoft Belief Network / MSR DTAS XML) reader/writer.

Port of ``pgmpy_tpu/readwrite/xbn.py``; parity: the reference pgmpy's
``pgmpy/readwrite/XMLBeliefNetwork.py``.  Each
``<DPI INDEXES="...">`` row gives the child distribution for one parent
configuration (CONDSET order, indexes explicit).
"""

from xml.etree import ElementTree as etree

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD
from pgmpy_tpu_torch.readwrite.bif import open_text


class XBNReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path, "rb") as f:
                self.network = etree.parse(f).getroot()
        elif string is not None:
            self.network = etree.fromstring(string)
        else:
            raise ValueError("Must specify either path or string")
        self.bnmodel = self.network.find("BNMODEL")
        self.analysisnotebook = self.get_analysisnotebook_values()
        self.model_name = self.get_bnmodel_name()
        self.static_properties = self.get_static_properties()
        self.variables = self.get_variables()
        self.edges = self.get_edges()
        self.variable_CPD = self.get_distributions()

    def get_analysisnotebook_values(self):
        return dict(self.network.attrib)

    def get_bnmodel_name(self):
        # the reference's model-driven writer emits NAME as a child element
        # rather than an attribute; accept both
        name = self.bnmodel.get("NAME")
        if name is None:
            name_el = self.bnmodel.find("NAME")
            name = name_el.text if name_el is not None else None
        return name

    def get_static_properties(self):
        static = self.bnmodel.find("STATICPROPERTIES")
        if static is None:  # optional (reference-written files omit it)
            return {}
        return {prop.tag: prop.get("VALUE") for prop in static}

    def get_variables(self):
        variables = {}
        for var in self.bnmodel.find("VARIABLES"):
            variables[var.get("NAME")] = {
                "TYPE": var.get("TYPE"),
                "XPOS": var.get("XPOS"),
                "YPOS": var.get("YPOS"),
                "DESCRIPTION": (var.find("DESCRIPTION").text if var.find("DESCRIPTION") is not None else ""),
                "STATES": [s.text for s in var.findall("STATENAME")],
            }
        return variables

    def get_edges(self):
        return [
            (arc.get("PARENT"), arc.get("CHILD"))
            for arc in self.bnmodel.find("STRUCTURE")
        ]

    def get_distributions(self):
        distribution = {}
        for dist in self.bnmodel.find("DISTRIBUTIONS"):
            var_name = dist.find("PRIVATE").get("NAME")
            entry = {"TYPE": dist.get("TYPE")}
            condset = dist.find("CONDSET")
            if condset is not None:
                entry["CONDSET"] = [e.get("NAME") for e in condset.findall("CONDELEM")]
                entry["CARDINALITY"] = [
                    len(self.variables[p]["STATES"]) for p in entry["CONDSET"]
                ]
            card = len(self.variables[var_name]["STATES"])
            dpis = dist.find("DPIS")
            if condset is None:
                values = [float(x) for x in dpis.find("DPI").text.split()]
                entry["DPIS"] = np.asarray(values).reshape(card, 1)
            else:
                parent_cards = entry["CARDINALITY"]
                n_cols = int(np.prod(parent_cards))
                table = np.zeros((card, n_cols))
                for dpi in dpis.findall("DPI"):
                    idx = [int(x) for x in dpi.get("INDEXES").split()]
                    col = int(np.ravel_multi_index(idx, parent_cards))
                    table[:, col] = [float(x) for x in dpi.text.split()]
                entry["DPIS"] = table
            distribution[var_name] = entry
        return distribution

    def get_model(self):
        from pgmpy_tpu_torch.models.discrete_bn import DiscreteBayesianNetwork

        model = DiscreteBayesianNetwork()
        model.add_nodes_from(list(self.variables))
        model.add_edges_from(self.edges)
        model.name = self.model_name

        cpds = []
        for var, dist in self.variable_CPD.items():
            states = self.variables[var]["STATES"]
            parents = dist.get("CONDSET", [])
            state_names = {var: states}
            for p in parents:
                state_names[p] = self.variables[p]["STATES"]
            cpds.append(
                TabularCPD(
                    var,
                    len(states),
                    dist["DPIS"],
                    evidence=parents or None,
                    evidence_card=dist.get("CARDINALITY") or None,
                    state_names=state_names,
                )
            )
        model.add_cpds(*cpds)
        return model


class XBNWriter:
    def __init__(self, model, encoding="utf-8", prettyprint=True):
        model.check_model()
        self.model = model
        self.encoding = encoding
        self.prettyprint = prettyprint

        self.network = etree.Element(
            "ANALYSISNOTEBOOK",
            attrib={"NAME": getattr(model, "name", None) or "Notebook", "ROOT": "root"},
        )
        self.bnmodel = etree.SubElement(
            self.network, "BNMODEL", attrib={"NAME": getattr(model, "name", None) or "root"}
        )
        static = etree.SubElement(self.bnmodel, "STATICPROPERTIES")
        etree.SubElement(static, "FORMAT", attrib={"VALUE": "MSR DTAS XML"})
        etree.SubElement(static, "VERSION", attrib={"VALUE": "0.2"})
        etree.SubElement(static, "CREATOR", attrib={"VALUE": "pgmpy_tpu"})

        variables = etree.SubElement(self.bnmodel, "VARIABLES")
        for var in sorted(model.nodes(), key=str):
            cpd = model.get_cpds(var)
            var_el = etree.SubElement(
                variables, "VAR", attrib={"NAME": str(var), "TYPE": "discrete"}
            )
            # the reference READER requires a DESCRIPTION element per VAR
            # (XMLBeliefNetwork.py:117 calls .find("DESCRIPTION").text
            # unguarded); its writer emits one with a DESCRIPTION attribute
            etree.SubElement(var_el, "DESCRIPTION", attrib={"DESCRIPTION": ""})
            for state in cpd.state_names[var]:
                etree.SubElement(var_el, "STATENAME").text = str(state)

        structure = etree.SubElement(self.bnmodel, "STRUCTURE")
        for parent, child in sorted(model.edges(), key=str):
            etree.SubElement(
                structure, "ARC", attrib={"PARENT": str(parent), "CHILD": str(child)}
            )

        distributions = etree.SubElement(self.bnmodel, "DISTRIBUTIONS")
        for var in sorted(model.nodes(), key=str):
            cpd = model.get_cpds(var)
            dist = etree.SubElement(
                distributions, "DIST", attrib={"TYPE": "discrete"}
            )
            parents = cpd.variables[1:]
            if parents:
                condset = etree.SubElement(dist, "CONDSET")
                for p in parents:
                    etree.SubElement(condset, "CONDELEM", attrib={"NAME": str(p)})
            etree.SubElement(dist, "PRIVATE", attrib={"NAME": str(var)})
            dpis = etree.SubElement(dist, "DPIS")
            values = cpd.get_values()
            if parents:
                parent_cards = [len(cpd.state_names[p]) for p in parents]
                for col, idx in enumerate(np.ndindex(*parent_cards)):
                    dpi = etree.SubElement(
                        dpis, "DPI", attrib={"INDEXES": " ".join(map(str, idx))}
                    )
                    dpi.text = " ".join(repr(float(v)) for v in values[:, col])
            else:
                etree.SubElement(dpis, "DPI").text = " ".join(
                    repr(float(v)) for v in values[:, 0]
                )

    # ------------------------------------------------------------------ #
    # reference-style section setters (ref XMLBeliefNetwork.py writer API):
    # mutate the XML tree built in __init__
    # ------------------------------------------------------------------ #
    def set_analysisnotebook(self, **data):
        for key, value in data.items():
            self.network.set(str(key), str(value))

    def set_bnmodel_name(self, name):
        self.bnmodel.set("NAME", str(name))

    def set_static_properties(self, **data):
        static = self.bnmodel.find("STATICPROPERTIES")
        for key, value in data.items():
            etree.SubElement(static, str(key), attrib={"VALUE": str(value)})

    def set_variables(self, data):
        """Rebuild the VARIABLES section from a reader-format dict
        {name: {"TYPE": ..., "XPOS": ..., "YPOS": ..., "DESCRIPTION": ...,
        "STATES": [...]}}."""
        variables = self.bnmodel.find("VARIABLES")
        for el in list(variables):
            variables.remove(el)
        for name, info in data.items():
            attrib = {"NAME": str(name), "TYPE": info.get("TYPE", "discrete")}
            for key in ("XPOS", "YPOS"):
                if info.get(key) is not None:
                    attrib[key] = str(info[key])
            var_el = etree.SubElement(variables, "VAR", attrib=attrib)
            if info.get("DESCRIPTION"):
                etree.SubElement(var_el, "DESCRIPTION").text = info["DESCRIPTION"]
            for state in info.get("STATES", []):
                etree.SubElement(var_el, "STATENAME").text = str(state)

    def set_edges(self, edge_list):
        structure = self.bnmodel.find("STRUCTURE")
        for el in list(structure):
            structure.remove(el)
        for parent, child in edge_list:
            etree.SubElement(
                structure, "ARC",
                attrib={"PARENT": str(parent), "CHILD": str(child)},
            )

    def set_distributions(self):
        """Rebuild the DISTRIBUTIONS section from the model's CPDs."""
        distributions = self.bnmodel.find("DISTRIBUTIONS")
        for el in list(distributions):
            distributions.remove(el)
        for var in sorted(self.model.nodes(), key=str):
            cpd = self.model.get_cpds(var)
            dist = etree.SubElement(
                distributions, "DIST", attrib={"TYPE": "discrete"}
            )
            parents = cpd.variables[1:]
            if parents:
                condset = etree.SubElement(dist, "CONDSET")
                for p in parents:
                    etree.SubElement(condset, "CONDELEM", attrib={"NAME": str(p)})
            etree.SubElement(dist, "PRIVATE", attrib={"NAME": str(var)})
            dpis = etree.SubElement(dist, "DPIS")
            values = cpd.get_values()
            if parents:
                parent_cards = [len(cpd.state_names[p]) for p in parents]
                for col, idx in enumerate(np.ndindex(*parent_cards)):
                    dpi = etree.SubElement(
                        dpis, "DPI", attrib={"INDEXES": " ".join(map(str, idx))}
                    )
                    dpi.text = " ".join(repr(float(v)) for v in values[:, col])
            else:
                etree.SubElement(dpis, "DPI").text = " ".join(
                    repr(float(v)) for v in values[:, 0]
                )

    def indent(self, elem, level=0):
        """In-place pretty-print formatter (reference XBN writer surface);
        delegates to the stdlib ElementTree indenter."""
        etree.indent(elem, space="  ", level=level)
        return elem

    def __str__(self):
        if self.prettyprint:
            self.indent(self.network)
        string = etree.tostring(self.network, encoding=self.encoding)
        return string.decode(self.encoding)

    def write_xbn(self, filename):
        self.write_file(filename)

    def write(self, filename):
        """Reference-name alias for write_file."""
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(str(self))
