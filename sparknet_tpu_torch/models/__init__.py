"""Model definitions shipped with the port: the AlexNet deploy net, the
AlexNet train_val net and solver, and the three cifar10_quick files
(copies of the JAX package's; the cifar10_quick solver names its net by
the bare file name, which resolves beside the solver)."""

import os

PROTOTXT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prototxt")
ALEXNET_DEPLOY = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_deploy.prototxt")
ALEXNET_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_train_val.prototxt")
ALEXNET_SOLVER = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_solver.prototxt")
CIFAR_QUICK_TRAIN_TEST = os.path.join(PROTOTXT_DIR, "cifar10_quick_train_test.prototxt")
CIFAR_QUICK_SOLVER = os.path.join(PROTOTXT_DIR, "cifar10_quick_solver.prototxt")
CIFAR_QUICK_DEPLOY = os.path.join(PROTOTXT_DIR, "cifar10_quick_deploy.prototxt")
