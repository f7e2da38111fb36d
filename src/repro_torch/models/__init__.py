"""Model code of the port (counterpart of ``repro.models``): the dense
transformer and the paper's CIFAR-100 ResNet-50."""
