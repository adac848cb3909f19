"""Model definitions shipped with the port: the AlexNet deploy net, the
train_val nets and solvers of ImageNetApp's four architectures (AlexNet,
GoogLeNet, ResNet-50, VGG-16), the three cifar10_quick files, LeNet's
train_test net and solver (its ``Data`` sources ``mnist_train_lmdb`` and
``mnist_test_lmdb`` resolve from the working directory, as in Caffe's
example; ``tools/convert_mnist_data.py`` writes them) and the char_rnn
deploy net (Embed, LSTM, InnerProduct, Softmax); copies of the JAX
package's. The cifar10_quick and LeNet solvers name their nets by the
bare file name, which resolves beside the solver, as the other solvers'
``net:`` lines do."""

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
LENET_TRAIN_TEST = os.path.join(PROTOTXT_DIR, "lenet_train_test.prototxt")
LENET_SOLVER = os.path.join(PROTOTXT_DIR, "lenet_solver.prototxt")
CHAR_RNN_DEPLOY = os.path.join(PROTOTXT_DIR, "char_rnn_deploy.prototxt")
