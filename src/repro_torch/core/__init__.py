"""The paper's compiler: frontend -> interp -> ir -> passes -> schedule ->
emit (numpy functional model) and emit_cuda (the kernel tier)."""
