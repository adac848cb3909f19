"""Model definitions shipped with the port: the AlexNet deploy net, and
the AlexNet train_val net and solver (copies of the JAX package's)."""

import os

PROTOTXT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prototxt")
ALEXNET_DEPLOY = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_deploy.prototxt")
ALEXNET_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_train_val.prototxt")
ALEXNET_SOLVER = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_solver.prototxt")
