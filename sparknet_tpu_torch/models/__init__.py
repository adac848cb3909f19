"""Model definitions shipped with the port (deploy prototxts)."""

import os

PROTOTXT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prototxt")
ALEXNET_DEPLOY = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_deploy.prototxt")
