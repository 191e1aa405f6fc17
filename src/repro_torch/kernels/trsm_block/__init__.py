"""Block-apply kernel: the blocked solve's batched ``Dinv @ rhs``."""
