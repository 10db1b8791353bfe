"""MirrorDescentEstimator: fit Markov-network potentials to empirical
marginals.

Port of ``pgmpy_tpu/estimators/mirror_descent.py``.  The caller picks which
marginals to fit (variable tuples, each matched to the first junction-tree
clique that contains it); the fit is exponentiated-gradient descent on the
clique log-potentials, the model's marginals coming from one calibration of
the junction tree per step (``JunctionTreeProgram.calibrate``, the program
built once).  The returned ``JunctionTree`` carries the fitted count-space
clique marginals as its factors.

The log-potentials, the model marginals, their projections onto the target
scopes, the gradient and the step all stay tensors on ``config.DEVICE`` in
float64 (the calibration itself runs in ``config.DTYPE``); per iteration the
host reads two numbers, the loss and the gradient's largest entry.
``losses`` keeps the loss of every accepted iterate.
"""

import torch

from pgmpy_tpu_torch.config import config
from pgmpy_tpu_torch.estimators.base import MarginalEstimator
from pgmpy_tpu_torch.factors.discrete import DiscreteFactor

_F64 = torch.float64


class MirrorDescentEstimator(MarginalEstimator):
    def estimate(
        self,
        marginals=None,
        metric="L2",
        iterations=100,
        stepsize=None,
        show_progress=True,
        estimate_type=None,
    ):
        """Fit clique potentials so the model's marginals over each scope in
        ``marginals`` match the empirical count marginals.

        marginals: list of variable tuples (default: every clique).  Each
            must be contained in some clique of the junction tree.
        metric: "L2" (gradient = difference) or "L1" (sign of difference).
        stepsize: fixed step on the log-potentials; None picks ``2/n`` with
            backtracking (halve on loss increase, grow by 1.2 on success).
        estimate_type: deprecated alias for ``metric``.

        Returns the fitted JunctionTree (factors = count-space marginals).
        """
        from pgmpy_tpu_torch.factors.factor_dict import FactorDict
        from pgmpy_tpu_torch.inference.bp import BeliefPropagation

        if estimate_type is not None:
            metric = estimate_type
        if metric not in ("L1", "L2"):
            raise ValueError("Metric must be one of L1 or L2.")

        jt = self.model
        cliques = list(jt.nodes())
        n = float(self.data.shape[0])
        device = config.DEVICE

        if marginals is None:
            marginals = [tuple(c) for c in cliques]
        observed = FactorDict.from_dataframe(self.data, [tuple(m) for m in marginals])
        card = {clique: jt.get_factors(clique).cardinality for clique in cliques}
        varorder = {clique: list(jt.get_factors(clique).variables) for clique in cliques}

        # per clique and target: (the target counts, the clique axes summed
        # out, the permutations to the target's axis order and back, the
        # shape from which the gradient broadcasts over the clique)
        targets = {clique: [] for clique in cliques}
        for scope in marginals:
            y = observed[tuple(scope)]
            for clique in cliques:
                if set(scope) <= set(clique):
                    break
            else:
                raise ValueError(
                    f"Could not find a corresponding clique for marginal: {scope}"
                    f" out of cliques: {cliques}"
                )
            order = varorder[clique]
            keep = [order.index(v) for v in y.variables]
            drop = tuple(i for i in range(len(order)) if i not in keep)
            # the projection's axes come out ascending; reorder them to y's
            to_y = [sorted(keep).index(a) for a in keep]
            back = [keep.index(a) for a in sorted(keep)]
            shape = [1] * len(order)
            for ax in keep:
                shape[ax] = int(card[clique][ax])
            values = y.values.to(device=device, dtype=_F64)
            targets[clique].append((values, drop, to_y, back, shape))

        prev = getattr(self, "theta", None)
        if prev:
            log_theta = {c: prev[c].values.to(device=device, dtype=_F64) for c in cliques}
        else:
            log_theta = {
                c: torch.zeros([int(k) for k in card[c]], dtype=_F64, device=device)
                for c in cliques
            }

        # the calibration program depends only on the structure: build it
        # once and feed it new potentials every step
        bp = BeliefPropagation(jt)
        program = bp._program
        factor_cliques = [
            next(c for c in cliques if set(c) == set(f.variables)) for f in bp._input_factors
        ]
        factor_perm = [
            [varorder[c].index(v) for v in f.variables]
            for f, c in zip(bp._input_factors, factor_cliques)
        ]
        belief_perm = {}
        for c in cliques:
            prog_clique = next(pc for pc in program.cliques if set(pc) == set(c))
            belief_perm[c] = (program.index[prog_clique],
                              [list(prog_clique).index(v) for v in varorder[c]])

        def model_marginals(theta):
            """One calibration -> count-space clique marginals (float64)."""
            arrays = [
                torch.exp(theta[c]).permute(perm).to(config.DTYPE)
                for c, perm in zip(factor_cliques, factor_perm)
            ]
            beliefs, _ = program.calibrate(arrays)
            mu = {}
            for c in cliques:
                idx, perm = belief_perm[c]
                m = beliefs[idx].permute(perm).to(_F64)
                mu[c] = m / torch.clamp_min(m.sum(), 1e-300) * n
            return mu

        def loss_and_grad(mu):
            """(a device tensor [loss, max |grad|], the gradient per clique)."""
            loss = torch.zeros((), dtype=_F64, device=device)
            grad = {}
            for c in cliques:
                g = torch.zeros_like(mu[c])
                for values, drop, to_y, back, shape in targets[c]:
                    proj = mu[c].sum(dim=drop) if drop else mu[c]
                    diff = proj.permute(to_y) - values
                    if metric == "L1":
                        loss = loss + diff.abs().sum()
                        d = torch.sign(diff)
                    else:
                        loss = loss + 0.5 * (diff * diff).sum()
                        d = diff
                    g = g + d.permute(back).reshape(shape)
                grad[c] = g
            g_max = torch.stack([g.abs().max() for g in grad.values()]).max()
            return torch.stack([loss, g_max]), grad

        alpha = float(stepsize) if stepsize is not None else 2.0 / max(n, 1.0)
        line_search = stepsize is None
        mu = model_marginals(log_theta)
        read, grad = loss_and_grad(mu)
        loss = float(read[0])
        self.losses = [loss]  # the loss of every accepted iterate
        for _ in range(int(iterations)):
            new_theta = {c: log_theta[c] - alpha * grad[c] for c in cliques}
            new_mu = model_marginals(new_theta)
            new_read, new_grad = loss_and_grad(new_mu)
            new_loss, g_max = new_read.tolist()
            if line_search and new_loss > loss and alpha > 1e-12:
                alpha *= 0.5
                continue
            if line_search:
                alpha *= 1.2
            log_theta, mu, loss, grad = new_theta, new_mu, new_loss, new_grad
            self.losses.append(loss)
            if g_max < 1e-6 * n:
                break

        def factors(tables):
            return [
                DiscreteFactor(varorder[c], [int(k) for k in card[c]], tables[c],
                               state_names=dict(jt.get_factors(c).state_names))
                for c in cliques
            ]

        # the returned tree carries the count-space marginals; a calibrated
        # BP over the fitted potentials serves later queries
        self.theta = dict(zip(cliques, factors(log_theta)))
        pot_jt = jt.copy()
        pot_jt.factors = factors({c: torch.exp(t) for c, t in log_theta.items()})
        bp = BeliefPropagation(pot_jt)
        bp.calibrate()
        self.belief_propagation = bp
        jt.factors = factors(mu)
        return jt
