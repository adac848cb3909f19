"""Model definitions shipped with the port: the AlexNet deploy net, the
train_val nets and solvers of ImageNetApp's four architectures (AlexNet,
GoogLeNet, ResNet-50, VGG-16), and the three cifar10_quick files
(copies of the JAX package's; the cifar10_quick solver names its net by
the bare file name, which resolves beside the solver, as the other
solvers' ``net:`` lines do)."""

import os

PROTOTXT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prototxt")
ALEXNET_DEPLOY = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_deploy.prototxt")
ALEXNET_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_train_val.prototxt")
ALEXNET_SOLVER = os.path.join(PROTOTXT_DIR, "bvlc_alexnet_solver.prototxt")
GOOGLENET_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "bvlc_googlenet_train_val.prototxt")
GOOGLENET_SOLVER = os.path.join(PROTOTXT_DIR, "bvlc_googlenet_quick_solver.prototxt")
RESNET50_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "resnet50_train_val.prototxt")
RESNET50_SOLVER = os.path.join(PROTOTXT_DIR, "resnet50_solver.prototxt")
VGG16_TRAIN_VAL = os.path.join(PROTOTXT_DIR, "vgg16_train_val.prototxt")
VGG16_SOLVER = os.path.join(PROTOTXT_DIR, "vgg16_solver.prototxt")
CIFAR_QUICK_TRAIN_TEST = os.path.join(PROTOTXT_DIR, "cifar10_quick_train_test.prototxt")
CIFAR_QUICK_SOLVER = os.path.join(PROTOTXT_DIR, "cifar10_quick_solver.prototxt")
CIFAR_QUICK_DEPLOY = os.path.join(PROTOTXT_DIR, "cifar10_quick_deploy.prototxt")
