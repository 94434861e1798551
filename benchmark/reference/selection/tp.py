"""One process's tensor-parallel hooks: every layer whole, no exchange."""


def group_size(group) -> int:
    return 1


def copy_to_model(x, group):
    return x


def reduce_from_model(x, group):
    return x


def gather_from_model(x, group):
    return x
