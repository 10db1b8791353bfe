"""PomdpX reader/writer (APPL POMDP interchange format).

Port of ``pgmpy_tpu/readwrite/pomdpx.py``; parity: the reference pgmpy's
``pgmpy/readwrite/PomdpX.py`` — table-type (TBL)
parameters; output structures mirror the reference's dict shapes.
"""

from collections import defaultdict
from xml.dom import minidom
from xml.etree import ElementTree as etree

from pgmpy_tpu_torch.readwrite.bif import open_text


class PomdpXReader:
    def __init__(self, path=None, string=None):
        if path is not None:
            with open_text(path, "rb") as f:
                self.network = etree.parse(f).getroot()
        elif string is not None:
            self.network = etree.fromstring(string)
        else:
            raise ValueError("Must specify either path or string")

    def get_description(self):
        el = self.network.find("Description")
        return el.text.strip() if el is not None and el.text else ""

    def get_discount(self):
        return float(self.network.find("Discount").text)

    def get_variables(self):
        self.variables = defaultdict(list)
        for variable in self.network.findall("Variable"):
            for var in variable.findall("StateVar"):
                state_variables = {
                    "vnamePrev": var.get("vnamePrev"),
                    "vnameCurr": var.get("vnameCurr"),
                    "fullyObs": bool(var.get("fullyObs")),
                    "ValueEnum": [],
                }
                if var.find("NumValues") is not None:
                    state_variables["ValueEnum"] = [
                        f"s{i}" for i in range(int(var.find("NumValues").text))
                    ]
                if var.find("ValueEnum") is not None:
                    state_variables["ValueEnum"] = var.find("ValueEnum").text.split()
                self.variables["StateVar"].append(state_variables)
            for var in variable.findall("ObsVar"):
                self.variables["ObsVar"].append(
                    {
                        "vname": var.get("vname"),
                        "ValueEnum": var.find("ValueEnum").text.split(),
                    }
                )
            for var in variable.findall("ActionVar"):
                self.variables["ActionVar"].append(
                    {
                        "vname": var.get("vname"),
                        "ValueEnum": var.find("ValueEnum").text.split(),
                    }
                )
            for var in variable.findall("RewardVar"):
                self.variables["RewardVar"].append({"vname": var.get("vname")})
        return self.variables

    def _get_cond_probs(self, section_tag, entry_tag="CondProb", table_tag="ProbTable"):
        out = []
        for section in self.network.findall(section_tag):
            for var in section.findall(entry_tag):
                parameter_el = var.find("Parameter")
                param_type = parameter_el.get("type") or "TBL"
                cond = {
                    "Var": var.find("Var").text,
                    "Parent": var.find("Parent").text.split(),
                    "Type": param_type,
                    "Parameter": [],
                }
                if param_type == "DD":
                    cond["Parameter"] = self.get_parameter_dd(parameter_el)
                else:
                    for entry in parameter_el.findall("Entry"):
                        instance = entry.find("Instance").text.split()
                        table_el = entry.find(table_tag)
                        if table_el is None:
                            table_el = entry.find("ValueTable")
                        cond["Parameter"].append(
                            {
                                "Instance": instance,
                                table_el.tag: table_el.text.split(),
                            }
                        )
                out.append(cond)
        return out

    def get_parameter_dd(self, parameter):
        """Decision-diagram parameter as nested dicts: {root var: edges},
        where an edge value is a terminal string, a nested {var: edges}
        node, or a SubDAG attribute dict; an optional SubDAGTemplate rides
        along under its own key (ref PomdpX.py:308-350)."""
        parameter_el = parameter

        def parse_node(node_el):
            edges = {}
            for edge in node_el.findall("Edge"):
                terminal = edge.find("Terminal")
                child = edge.find("Node")
                subdag = edge.find("SubDAG")
                if terminal is not None:
                    edges[edge.get("val")] = terminal.text
                elif child is not None:
                    edges[edge.get("val")] = {child.get("var"): parse_node(child)}
                elif subdag is not None:
                    attrs = {"type": subdag.get("type")}
                    if attrs["type"] == "template":
                        attrs["idref"] = subdag.get("idref")
                    if subdag.get("var"):
                        attrs["var"] = subdag.get("var")
                    if subdag.get("val"):
                        attrs["val"] = subdag.get("val")
                    edges[edge.get("val")] = attrs
            return edges

        dag = {}
        template = parameter_el.find("SubDAGTemplate")
        if template is not None:
            template_root = template.find("Node")
            dag["SubDAGTemplate"] = {
                template_root.get("var"): parse_node(template_root)
            }
            dag["id"] = template.get("id")
        root = parameter_el.find("DAG").find("Node")
        dag[root.get("var")] = parse_node(root)
        return dag

    def get_parameter(self, var):
        """Parameter block of a CondProb/Func element: dispatches on the
        declared type (TBL default, DD for decision diagrams — ref
        PomdpX.py:136-276)."""
        parameter_el = var.find("Parameter")
        if parameter_el is None:
            return {}
        ptype = parameter_el.get("type", "TBL")
        if ptype == "DD":
            return self.get_parameter_dd(parameter_el)
        return self.get_parameter_tbl(parameter_el)

    def get_parameter_tbl(self, parameter):
        """[{Instance: [...], ProbTable/ValueTable: [...]}] rows of a
        TBL-typed parameter."""
        parameter_el = parameter
        rows = []
        for entry in parameter_el.findall("Entry"):
            instance = entry.find("Instance").text.split()
            table_el = entry.find("ProbTable")
            key = "ProbTable"
            if table_el is None:
                table_el = entry.find("ValueTable")
                key = "ValueTable"
            rows.append({"Instance": instance, key: table_el.text.split()})
        return rows

    def get_initial_beliefs(self):
        return self._get_cond_probs("InitialStateBelief")

    def get_state_transition_function(self):
        return self._get_cond_probs("StateTransitionFunction")

    def get_obs_function(self):
        return self._get_cond_probs("ObsFunction")

    def get_reward_function(self):
        return self._get_cond_probs(
            "RewardFunction", entry_tag="Func", table_tag="ValueTable"
        )


class PomdpXWriter:
    def __init__(self, model_data, encoding="utf-8", prettyprint=True):
        """``model_data``: dict with keys description, discount, variables,
        initial_state_belief, state_transition_function, obs_function,
        reward_function (shapes as produced by PomdpXReader)."""
        self.model = model_data
        self.encoding = encoding
        self.prettyprint = prettyprint

        self.xml = etree.Element("pomdpx", attrib={"version": "1.0", "id": "model"})
        etree.SubElement(self.xml, "Description").text = self.model.get("description", "")
        etree.SubElement(self.xml, "Discount").text = str(self.model.get("discount", 0.95))

        variable = etree.SubElement(self.xml, "Variable")
        variables = self.model.get("variables", {})
        for var in variables.get("StateVar", []):
            attrib = {"vnamePrev": var["vnamePrev"], "vnameCurr": var["vnameCurr"]}
            if var.get("fullyObs"):
                attrib["fullyObs"] = "true"
            el = etree.SubElement(variable, "StateVar", attrib=attrib)
            etree.SubElement(el, "ValueEnum").text = " ".join(var["ValueEnum"])
        for var in variables.get("ObsVar", []):
            el = etree.SubElement(variable, "ObsVar", attrib={"vname": var["vname"]})
            etree.SubElement(el, "ValueEnum").text = " ".join(var["ValueEnum"])
        for var in variables.get("ActionVar", []):
            el = etree.SubElement(variable, "ActionVar", attrib={"vname": var["vname"]})
            etree.SubElement(el, "ValueEnum").text = " ".join(var["ValueEnum"])
        for var in variables.get("RewardVar", []):
            etree.SubElement(variable, "RewardVar", attrib={"vname": var["vname"]})

        self._write_section(
            "InitialStateBelief", self.model.get("initial_state_belief", [])
        )
        self._write_section(
            "StateTransitionFunction",
            self.model.get("state_transition_function", []),
        )
        self._write_section("ObsFunction", self.model.get("obs_function", []))
        self._write_section(
            "RewardFunction",
            self.model.get("reward_function", []),
            entry_tag="Func",
            table_tag="ValueTable",
        )

    def add_conditions(self, condition, condprob, table_tag="ProbTable"):
        """Emit Var/Parent/Parameter of one condition block into
        ``condprob`` (ref PomdpX.py:526-592)."""
        etree.SubElement(condprob, "Var").text = condition["Var"]
        etree.SubElement(condprob, "Parent").text = " ".join(condition["Parent"])
        param_type = condition.get("Type", "TBL")
        parameter = etree.SubElement(
            condprob, "Parameter", attrib={"type": param_type}
        )
        if param_type == "DD":
            self.add_parameter_dd(parameter, condition["Parameter"])
            return
        for entry in condition["Parameter"]:
            e = etree.SubElement(parameter, "Entry")
            etree.SubElement(e, "Instance").text = " ".join(entry["Instance"])
            key = (
                table_tag
                if table_tag in entry
                else ("ProbTable" if "ProbTable" in entry else "ValueTable")
            )
            etree.SubElement(e, key).text = " ".join(entry[key])

    def add_parameter_dd(self, dag_tag, node_dict):
        """Emit a decision-diagram parameter into ``dag_tag`` (reference
        public name, ref PomdpX.py:474-526)."""
        self._write_parameter_dd(dag_tag, node_dict)

    def indent(self, elem, level=0):
        """In-place pretty-print formatter (ref PomdpX.py:392-409)."""
        i = "\n" + level * "  "
        if len(elem):
            if not elem.text or not elem.text.strip():
                elem.text = i + "  "
            if not elem.tail or not elem.tail.strip():
                elem.tail = i
            for child in elem:
                self.indent(child, level + 1)
            if not child.tail or not child.tail.strip():
                child.tail = i
        else:
            if level and (not elem.tail or not elem.tail.strip()):
                elem.tail = i

    def _section_string(self, el):
        if el is None:
            return ""
        import copy

        el = copy.deepcopy(el)
        if self.prettyprint:
            self.indent(el)
        return etree.tostring(el, encoding="unicode").rstrip("\n")

    def get_variables(self):
        """Serialized <Variable> section (ref PomdpX.py:433-474)."""
        return self._section_string(self.xml.find("Variable"))

    def add_initial_belief(self):
        return self._section_string(self.xml.find("InitialStateBelief"))

    def add_state_transition_function(self):
        return self._section_string(self.xml.find("StateTransitionFunction"))

    def add_obs_function(self):
        return self._section_string(self.xml.find("ObsFunction"))

    def add_reward_function(self):
        return self._section_string(self.xml.find("RewardFunction"))

    def _write_section(self, tag, cond_probs, entry_tag="CondProb", table_tag="ProbTable"):
        if not cond_probs:
            return
        section = etree.SubElement(self.xml, tag)
        for cond in cond_probs:
            el = etree.SubElement(section, entry_tag)
            self.add_conditions(cond, el, table_tag=table_tag)

    def _write_parameter_dd(self, parameter_el, dag_dict):
        """Inverse of PomdpXReader.get_parameter_dd (ref PomdpX.py:474-526)."""

        def write_node(parent_el, var, edges):
            node_el = etree.SubElement(parent_el, "Node", attrib={"var": var})
            for val in sorted(edges.keys(), key=str):
                edge_el = etree.SubElement(node_el, "Edge", attrib={"val": val})
                value = edges[val]
                if isinstance(value, str):
                    etree.SubElement(edge_el, "Terminal").text = value
                elif "type" in value:
                    attrs = {"type": value["type"]}
                    for key in ("idref", "var", "val"):
                        if key in value:
                            attrs[key] = value[key]
                    etree.SubElement(edge_el, "SubDAG", attrib=attrs)
                else:
                    child_var = next(iter(value.keys()))
                    write_node(edge_el, child_var, value[child_var])

        if "SubDAGTemplate" in dag_dict:
            template_el = etree.SubElement(
                parameter_el, "SubDAGTemplate", attrib={"id": dag_dict.get("id", "")}
            )
            template = dag_dict["SubDAGTemplate"]
            var = next(iter(template.keys()))
            write_node(template_el, var, template[var])
        dag_el = etree.SubElement(parameter_el, "DAG")
        for var, edges in dag_dict.items():
            if var in ("SubDAGTemplate", "id"):
                continue
            write_node(dag_el, var, edges)

    def __str__(self):
        string = etree.tostring(self.xml, encoding=self.encoding)
        if self.prettyprint:
            return minidom.parseString(string).toprettyxml(indent="  ")
        return string.decode(self.encoding)

    def write_pomdpx(self, filename):
        self.write_file(filename)

    def write_file(self, filename):
        with open_text(filename, "w") as f:
            f.write(str(self))
