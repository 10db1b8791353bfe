"""How far a change at the level of rounding moves an SEM fit.

Run from the repository root:

    python3 tools/sem_fit_sensitivity.py [--device cpu|cuda] [--parts sensitivity,ols,bollen]

On the rows ``chip_smoke.py`` fits (Bollen's model and ecoli70 as a path
SEM, 50,000 rows each, ML, Adam at lr 0.05), it multiplies every value by
``1 + eps * N(0, 1)`` and prints, per line, the largest change of the fitted
``B`` after a fixed number of steps (``exit_delta=0``): in float32 with eps
1e-7 and in float64 with eps 1e-15.  Then it fits ecoli70 with the default
stopping rule on ten such copies (eps 0 to 9e-7) and prints the steps each
ran and its largest distance from the per-equation OLS coefficients, the ML
optimum of a recursive path model.  Last, Bollen's fit on 16 draws of
50,000 rows, with the default ``max_iter`` (2000) and with 8000: per free
entry of ``B``, the mean and spread of its error in the asymptotic standard
errors ``chip_smoke.py`` derives, the steps run and the largest error per
draw; then the same for the smoke's own draw.  These
readings set the limits of ``chip_smoke.py``'s SEM checks (``SEM_FIT_LIMIT``,
``SEM_OLS_LIMIT``, ``BOLLEN_Z_LIMIT``).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from pgmpy_tpu_torch.config import config  # noqa: E402
from pgmpy_tpu_torch.estimators import SEMEstimator  # noqa: E402
from pgmpy_tpu_torch.models import SEM, LinearGaussianBayesianNetwork  # noqa: E402
from pgmpy_tpu_torch.utils import get_example_model  # noqa: E402


def jittered(df, eps, seed):
    return df * (1 + eps * np.random.default_rng(seed).standard_normal(df.shape))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--parts", default="sensitivity,ols,bollen")
    args = parser.parse_args()
    parts = args.parts.split(",")
    config.set_device(args.device)
    chip_smoke.check = lambda cond, msg: None  # the draw's device check is the smoke's
    bollen, bollen_df = chip_smoke.bollen_data(chip_smoke.SEED + 14)
    ecoli = get_example_model("ecoli70")
    ecoli_df = ecoli.simulate(chip_smoke.SEM_ROWS, seed=chip_smoke.SEED + 15)
    ecoli_sem = SEM.from_graph(ebunch=list(ecoli.edges()))

    for name, sem, df in (("bollen", bollen, bollen_df), ("ecoli70", ecoli_sem, ecoli_df)):
        if "sensitivity" not in parts:
            break
        for dtype, eps in (("float32", 1e-7), ("float64", 1e-15)):
            config.set_dtype(dtype)
            changed = jittered(df, eps, seed=1)
            for steps in (64, 128, 256, 512, 1216, 2048):
                a = SEMEstimator(sem).fit(df, method="ml", max_iter=steps, exit_delta=0.0)
                b = SEMEstimator(sem).fit(changed, method="ml", max_iter=steps, exit_delta=0.0)
                print(f"sem_sensitivity {name} {dtype} eps {eps:g} steps {steps} "
                      f"max_abs_change_of_B {np.abs(a['B'] - b['B']).max():.3e}", flush=True)
    config.set_dtype("float32")

    ols = LinearGaussianBayesianNetwork(list(ecoli.edges()))
    ols.add_nodes_from(ecoli.nodes())
    ols.fit(ecoli_df)
    for k in range(10 if "ols" in parts else 0):
        estimator = SEMEstimator(ecoli_sem)
        loss = estimator.ml_loss = chip_smoke.StepCount(estimator.ml_loss)
        fit = estimator.fit(jittered(ecoli_df, 1e-7 * k, seed=k), method="ml")
        names = fit["variables"]
        err = max(abs(fit["B"][names.index(c.variable), names.index(p)] - b)
                  for c in ols.get_cpds() for p, b in zip(c.evidence, c.beta[1:]))
        print(f"sem_ols_spread ecoli70 eps {1e-7 * k:g} steps {loss.steps} "
              f"max_abs_from_ols {err:.3e}", flush=True)

    if "bollen" in parts:
        alg = bollen.to_lisrel()
        se = chip_smoke.bollen_standard_errors(alg, chip_smoke.SEM_ROWS)
        truth, _ = chip_smoke.bollen_parameters(alg)
        name = {at: f"{alg.variables[at[1]]}->{alg.variables[at[0]]}" for at in se}
        for max_iter in (2000, 8000):
            z, steps = [], []
            for draw in range(16):
                _, df = chip_smoke.bollen_data(1000 + draw)
                estimator = SEMEstimator(bollen)
                loss = estimator.ml_loss = chip_smoke.StepCount(estimator.ml_loss)
                B = estimator.fit(df, method="ml", max_iter=max_iter)["B"]
                z.append([(B[at] - truth[at]) / e for at, e in se.items()])
                steps.append(loss.steps)
            z = np.array(z)
            for j, at in enumerate(se):
                print(f"bollen_z max_iter {max_iter} {name[at]} se {se[at]:.3e} mean "
                      f"{z[:, j].mean():.3f} sd {z[:, j].std(ddof=1):.3f}", flush=True)
            print(f"bollen_z max_iter {max_iter} steps {' '.join(map(str, steps))} largest_per_draw "
                  f"{' '.join(f'{v:.2f}' for v in np.abs(z).max(axis=1))}", flush=True)
            estimator = SEMEstimator(bollen)
            loss = estimator.ml_loss = chip_smoke.StepCount(estimator.ml_loss)
            fit = estimator.fit(bollen_df, method="ml", max_iter=max_iter)
            worst = max(se, key=lambda at: abs(fit["B"][at] - truth[at]) / se[at])
            print(f"bollen_fit max_iter {max_iter} steps {loss.steps} loss {fit['loss']:.6f} "
                  f"largest_z {abs(fit['B'][worst] - truth[worst]) / se[worst]:.3f} "
                  f"({name[worst]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
