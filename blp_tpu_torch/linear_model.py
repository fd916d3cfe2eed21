"""L2-regularized logistic regression and the two accuracy scores of
node classification, in torch, so the port does not depend on scikit-learn.

`LogisticRegression(C, max_iter)` fits what scikit-learn's default
`LogisticRegression(C=C, max_iter=max_iter)` fits (lbfgs, L2 penalty, an
unpenalized intercept): it minimizes

    mean_i loss_i + ||W||^2 / (2 C n),

the same optimum as C * sum_i loss_i + ||W||^2 / 2. With more than two
classes the loss is the multinomial one, with one weight vector per class;
with two it is the binomial one, with a single weight vector (`coef_` of
shape (1, d)), as scikit-learn fits it: a two-class softmax would be another
optimum (that of the binomial loss at 2 C). The solve is
`torch.optim.LBFGS` with a strong-Wolfe line search in float64, from zeros,
in preconditioned variables (see `fit`), to a max-abs gradient of `GTOL`,
a million times tighter than scikit-learn's 1e-4.
"""

from __future__ import annotations

import numpy as np
import torch

from blp_tpu_torch.utils import resolve_device

#: LBFGS's gradient tolerance (scikit-learn's is 1e-4).
GTOL = 1e-10


class LogisticRegression:
    """fit(X, y) then predict(X); `coef_` (K, d) or (1, d) for two classes,
    `intercept_` (K,) or (1,), `classes_` the sorted labels (numpy)."""

    def __init__(self, C: float = 1.0, max_iter: int = 1000, *, device=None):
        self.C = float(C)
        self.max_iter = int(max_iter)
        self.device = device

    def fit(self, X, y) -> "LogisticRegression":
        dev = resolve_device(self.device)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(f"need at least 2 classes, got {self.classes_}")
        x = torch.as_tensor(np.asarray(X), dtype=torch.float64, device=dev)
        target = torch.as_tensor(np.searchsorted(self.classes_, y), device=dev)
        n, d = x.shape
        binary = len(self.classes_) == 2
        k = 1 if binary else len(self.classes_)
        l2 = 1.0 / (self.C * n)
        # Solved in the variables (v, c) with w = v A and b = c - w mean(x),
        # A = (cov(x) + l2 I)^(-1/2): the same objective, hence the same
        # optimum, with a Hessian near the identity. Embeddings are often
        # close to low rank, and in w itself LBFGS then spends its 1,000
        # iterations far from the optimum.
        mean = x.mean(0)
        xc = x - mean
        evals, evecs = torch.linalg.eigh(xc.T @ xc / n)
        a = (evecs * (evals.clamp(min=0) + l2).rsqrt()) @ evecs.T
        xa = xc @ a
        v = torch.zeros((k, d), dtype=torch.float64, device=dev,
                        requires_grad=True)
        c = torch.zeros((k,), dtype=torch.float64, device=dev,
                        requires_grad=True)

        def objective():
            z = xa @ v.T + c                                      # (n, k)
            if binary:
                z = z[:, 0]
                # log(1 + e^z) - y z, exact for large |z|.
                loss = torch.logaddexp(z, torch.zeros_like(z)) - target * z
            else:
                loss = (torch.logsumexp(z, dim=1)
                        - z.gather(1, target[:, None])[:, 0])
            w = v @ a
            return loss.mean() + 0.5 * l2 * (w * w).sum()

        opt = torch.optim.LBFGS(
            [v, c], lr=1.0, max_iter=self.max_iter,
            max_eval=self.max_iter * 50, tolerance_grad=GTOL,
            tolerance_change=1e-15, history_size=10,
            line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            f = objective()
            f.backward()
            return f

        opt.step(closure)
        with torch.no_grad():
            w = v @ a
            self.coef_ = w.cpu().numpy()
            self.intercept_ = (c - w @ mean).cpu().numpy()
        return self

    def decision_function(self, X) -> np.ndarray:
        """(n, K) scores, or (n,) for two classes (positive: classes_[1])."""
        z = np.asarray(X, np.float64) @ self.coef_.T + self.intercept_
        return z[:, 0] if len(self.classes_) == 2 else z

    def predict(self, X) -> np.ndarray:
        z = self.decision_function(X)
        if len(self.classes_) == 2:
            return self.classes_[(z > 0).astype(np.int64)]
        return self.classes_[np.argmax(z, axis=1)]


def accuracy_score(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def balanced_accuracy_score(y_true, y_pred) -> float:
    """Mean recall over the classes present in y_true."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    recalls = [np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]
    return float(np.mean(recalls))
