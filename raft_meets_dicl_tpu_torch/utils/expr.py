"""Safe arithmetic expression evaluator for config values (an own copy of
the JAX package's ``utils/expr.py``).

Configs may contain arithmetic over named variables, e.g. a scheduler's
``total_steps: '{n_epochs} * {n_batches} + 100'`` or checkpoint compare keys
``'{m_EndPointError_mean}'``. Variables are substituted via ``str.format``
and the result is evaluated by walking a restricted Python AST — only
numeric literals and arithmetic operators are allowed (parity with reference
src/utils/expr.py:5-33).
"""

import ast
import operator

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
}

_UNARYOPS = {
    ast.UAdd: operator.pos,
    ast.USub: operator.neg,
}


def _eval_node(node):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float)):
            return node.value
        raise ValueError(f"invalid constant in expression: {node.value!r}")
    if isinstance(node, ast.BinOp):
        op = _BINOPS.get(type(node.op))
        if op is None:
            raise ValueError(f"operator not allowed: {type(node.op).__name__}")
        return op(_eval_node(node.left), _eval_node(node.right))
    if isinstance(node, ast.UnaryOp):
        op = _UNARYOPS.get(type(node.op))
        if op is None:
            raise ValueError(f"operator not allowed: {type(node.op).__name__}")
        return op(_eval_node(node.operand))
    if isinstance(node, ast.Call):
        # allow min/max/round/int/float/abs for convenience in configs
        if isinstance(node.func, ast.Name) and node.func.id in ("min", "max", "round", "int", "float", "abs"):
            fn = {"min": min, "max": max, "round": round, "int": int, "float": float, "abs": abs}[node.func.id]
            return fn(*[_eval_node(a) for a in node.args])
        raise ValueError("function calls not allowed in expression")
    raise ValueError(f"invalid expression node: {type(node).__name__}")


def eval_math_expr(expr, args=None, **kwargs):
    """Evaluate an arithmetic expression, substituting ``{name}`` variables.

    Accepts plain numbers (returned as-is) and strings; variables may be
    passed as a dict (reference signature, src/utils/expr.py:5) or kwargs::

        eval_math_expr('{n_epochs} * {n_batches}', {'n_epochs': 2, 'n_batches': 50})
    """
    if isinstance(expr, (int, float)):
        return expr

    vars = dict(args or {}) | kwargs
    expr = str(expr).format_map(vars)
    tree = ast.parse(expr, mode="eval")
    return _eval_node(tree)
