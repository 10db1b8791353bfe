"""Text-model parsers: lavaan and dagitty syntax (host side).

Port of ``pgmpy_tpu/utils/parser.py``: hand parsers (``re`` only) for the
two model-description languages the reference supports
(``pgmpy/utils/parser.py``):

* lavaan: ``y ~ x1 + x2`` regressions, ``f =~ i1 + i2`` latent measurement,
  ``#``/``!`` comments.  Measurement lhs variables become latents.
* dagitty: ``dag { x -> y; u [latent] ... }``.
"""

import re


def parse_lavaan(lines):
    """Parse lavaan model lines -> (edge list, latent set)."""
    if isinstance(lines, str):
        lines = lines.splitlines()
    edges = []
    latents = set()
    for raw in lines:
        line = raw.split("#")[0].split("!")[0].strip()
        if not line:
            continue
        if "=~" in line:
            lhs, rhs = line.split("=~")
            lhs = lhs.strip()
            latents.add(lhs)
            for item in rhs.split("+"):
                item = _strip_coef(item)
                if item:
                    edges.append((lhs, item))
        elif "~~" in line:
            # residual covariance: ignored for DAG purposes
            continue
        elif "~" in line:
            lhs, rhs = line.split("~", 1)
            lhs = lhs.strip()
            for item in rhs.split("+"):
                item = _strip_coef(item)
                if item:
                    edges.append((item, lhs))
    return edges, latents


def _strip_coef(term):
    """Drop a leading numeric coefficient: '2*x' -> 'x'."""
    term = term.strip()
    if "*" in term:
        term = term.split("*", 1)[1].strip()
    return term


def parse_dagitty(string):
    """Parse a dagitty ``dag { ... }`` description -> (edges, latents)."""
    if isinstance(string, (list, tuple)):
        string = "\n".join(string)
    body_match = re.search(r"\{(.*)\}", string, flags=re.DOTALL)
    body = body_match.group(1) if body_match else string

    edges = []
    latents = set()
    # statements separated by ';' or newlines
    for stmt in re.split(r"[;\n]", body):
        stmt = stmt.strip()
        if not stmt:
            continue
        # node attribute declarations: name [latent,pos="..."]
        attr_match = re.match(r'^"?([^"\[\]]+?)"?\s*\[(.*)\]$', stmt)
        if attr_match and "->" not in stmt and "<-" not in stmt:
            name = attr_match.group(1).strip()
            attrs = attr_match.group(2)
            if "latent" in attrs or "unobserved" in attrs:
                latents.add(name)
            continue
        # edge chains: a -> b -> c ; also 'b <- a'
        if "->" in stmt or "<-" in stmt:
            tokens = re.split(r"(->|<->|<-)", stmt)
            tokens = [t.strip().strip('"') for t in tokens]
            for i in range(1, len(tokens), 2):
                lhs, op, rhs = tokens[i - 1], tokens[i], tokens[i + 1]
                lhs = re.sub(r"\[.*?\]", "", lhs).strip()
                rhs = re.sub(r"\[.*?\]", "", rhs).strip()
                if op == "->":
                    edges.append((lhs, rhs))
                elif op == "<-":
                    edges.append((rhs, lhs))
                else:  # bidirected: latent confounder
                    conf = f"u_{lhs}_{rhs}"
                    latents.add(conf)
                    edges.append((conf, lhs))
                    edges.append((conf, rhs))
    return edges, latents
