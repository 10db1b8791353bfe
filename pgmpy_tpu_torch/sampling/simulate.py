"""model.simulate backend: graph surgery (do / virtual evidence /
interventions / missingness) on host, then the compiled sampler.

Port of ``pgmpy_tpu/sampling/simulate.py``.
"""

import numpy as np

from pgmpy_tpu_torch.factors.cpd import TabularCPD


def simulate_model(
    model,
    n_samples=10,
    do=None,
    evidence=None,
    virtual_evidence=None,
    virtual_intervention=None,
    missing_prob=None,
    include_latents=False,
    partial_samples=None,
    seed=None,
    show_progress=True,
    return_full=False,
):
    from pgmpy_tpu_torch.sampling.forward import BayesianModelSampling

    model.check_model()
    state_names = model.states

    evidence = {} if evidence is None else dict(evidence)
    for var, state in evidence.items():
        if state not in state_names[var]:
            raise ValueError(f"Evidence state: {state} for {var} doesn't exist")
    do = {} if do is None else dict(do)
    for var, state in do.items():
        if state not in state_names[var]:
            raise ValueError(f"Do state: {state} for {var} doesn't exist")
    virtual_intervention = virtual_intervention or []
    virtual_evidence = list(virtual_evidence or [])

    if set(do) & set(evidence):
        raise ValueError("Variable can't be in both do and evidence")

    # copy only when surgery is needed — the plain path reuses the model's
    # cached compiled sampler
    needs_surgery = bool(do or virtual_intervention or virtual_evidence or missing_prob)
    working = model.copy() if needs_surgery else model

    # Step 1: interventions sever incoming edges
    if do or virtual_intervention:
        virt_nodes = [cpd.variables[0] for cpd in virtual_intervention]
        working = working.do(list(do.keys()) + virt_nodes)
        evidence = {**evidence, **do}
        virtual_evidence = [*virtual_evidence, *virtual_intervention]

    # Step 2: virtual evidence becomes binary likelihood children (shared
    # construction with inference)
    if virtual_evidence:
        from pgmpy_tpu_torch.inference.base import attach_virtual_evidence

        attach_virtual_evidence(working, virtual_evidence)
        for cpd in virtual_evidence:
            evidence["__" + str(cpd.variables[0])] = 0

    # Step 3: missingness mechanism variables
    missing_cpds = []
    if missing_prob is not None:
        missing_cpds = missing_prob if isinstance(missing_prob, list) else [missing_prob]
        for cpd in missing_cpds:
            if not isinstance(cpd, TabularCPD):
                raise ValueError(
                    f"missing_prob must be TabularCPD(s). Got {type(cpd)}"
                )
            variable = cpd.variables[0]
            if not str(variable).endswith("*"):
                raise ValueError(
                    f"Got {variable}. TabularCPD variable should end with * symbol "
                    "to represent missingness variable."
                )
            if str(variable).split("*")[0] not in working.nodes():
                raise ValueError(f"Got {variable}. TabularCPD variable not in model nodes.")
            if int(cpd.cardinality[0]) != 2:
                raise ValueError(
                    f"Got cardinality of variable = {int(cpd.cardinality[0])}. "
                    "Tabular CPD variable should have 2 possible states: "
                    "Missing (1) and Not Missing (0)"
                )
            working.add_node(variable)
            for node in cpd.variables[1:]:
                if node not in working.nodes():
                    raise ValueError(f"TabularCPD evidence {node} not in model nodes.")
                working.add_edge(node, variable)
            working.add_cpds(cpd)

    # Step 4/5: forward or rejection sampling
    sampler = BayesianModelSampling(working)
    if not evidence:
        samples = sampler.forward_sample(
            size=n_samples, include_latents=True, seed=seed,
            show_progress=show_progress, partial_samples=partial_samples,
        )
    else:
        samples = sampler.rejection_sample(
            size=n_samples,
            evidence=[(k, v) for k, v in evidence.items()],
            include_latents=True, seed=seed, show_progress=show_progress,
            partial_samples=partial_samples,
        )

    # drop the synthetic virtual-evidence children
    synth = [c for c in samples.columns if str(c).startswith("__")]
    samples = samples.drop(columns=synth)

    # Step 6: apply missingness masks
    if missing_cpds:
        samples = samples.astype("object")
        for cpd in missing_cpds:
            variable = str(cpd.variables[0])
            base = variable.split("*")[0]
            if return_full:
                samples[base + "_full"] = samples.loc[:, base]
            mask = samples[variable].astype(int) == 1
            samples.loc[mask, base] = np.nan
            samples.drop(columns=[variable], inplace=True)

    # Step 7: postprocess
    if include_latents:
        return samples.astype("category")
    keep = [c for c in samples.columns if c not in model.latents]
    return samples.loc[:, keep].astype("category")
