"""Expression trees over typed values and variable sets.

Re-implementation of the reference's (the counterpart of
ls1_mardyn_tpu/utils/expression.py) RPN expression engine
(src/utils/Expression.h, Expression.cpp:579-669): an
expression string is a whitespace-separated REVERSE POLISH token list
("sysinfo:freeram sysinfo:bufferram + sysinfo:mem_unit * float
1048576 /").  Tokens:

- single-char operators ``+ - * /`` pop two nodes;
- constants (digits/./-/E only) become int- or float-typed leaves
  (int iff the token has no '.'/'E', Expression.cpp:612-625);
- tokens containing ``:`` are variables ``group:name`` resolved
  against a :class:`VariableSet` at evaluation time;
- anything else is a function: 1-arg ``abs float int floor ceil round
  sqrt ln|logE lb|log2 lg|log10 exp sin cos tan asin acos atan``,
  2-arg ``min max mod pow``, and the variable-set store/recall pair
  ``sto`` (2-arg: value, variable) / ``rcl`` (1-arg)
  (Expression.cpp:276-336).

Values stay int/float typed like the reference's
``Expression::Value`` union: int arithmetic stays int (C-style
truncating division), any float operand promotes (Expression.h
operator+/-/etc.).  This is host-side configuration/diagnostics
machinery (SysMonOutput expressions), not device compute — plain
Python is the right tool.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

Number = Union[int, float]

_FUNCS_1 = {
    "abs": abs,
    "float": float,
    "int": int,
    "floor": lambda v: int(math.floor(v)),
    "ceil": lambda v: int(math.ceil(v)),
    "round": lambda v: int(round(v)),
    "sqrt": math.sqrt,
    "ln": math.log,
    "loge": math.log,
    "lb": math.log2,
    "log2": math.log2,
    "lg": math.log10,
    "log10": math.log10,
    "exp": math.exp,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "asin": math.asin,
    "acos": math.acos,
    "atan": math.atan,
}

_FUNCS_2 = {
    "min": min,
    "max": max,
    "mod": lambda a, b: math.fmod(a, b) if isinstance(a, float)
    or isinstance(b, float) else int(math.fmod(a, b)),
    "pow": lambda a, b: a ** b,
}


class Variable:
    """A named, grouped, typed slot (Expression.h class Variable)."""

    def __init__(self, group: str, name: str):
        self.group = group
        self.name = name
        self.value: Number = 0

    @property
    def fullname(self) -> str:
        return f"{self.group}:{self.name}" if self.group else self.name

    def __repr__(self):
        return f"Variable({self.fullname}={self.value})"


class VariableSet:
    """Grouped variable registry (Expression.h class VariableSet)."""

    def __init__(self):
        self._vars: Dict[str, Variable] = {}

    @staticmethod
    def _split(fullname: str):
        if ":" in fullname:
            group, name = fullname.split(":", 1)
        else:
            group, name = "", fullname
        return group, name

    def add_variable(self, fullname: str) -> Variable:
        if fullname not in self._vars:
            self._vars[fullname] = Variable(*self._split(fullname))
        return self._vars[fullname]

    def set_variable(self, group_or_fullname: str,
                     name_or_value=None, value=None):
        """set_variable("g:n", v) or set_variable("g", "n", v)."""
        if value is None:
            fullname, v = group_or_fullname, name_or_value
        else:
            fullname, v = f"{group_or_fullname}:{name_or_value}", value
        self.add_variable(fullname).value = v

    def get_variable(self, fullname: str) -> Optional[Variable]:
        return self._vars.get(fullname)

    def exist_variable(self, fullname: str) -> bool:
        return fullname in self._vars

    def exist_variable_group(self, group: str) -> bool:
        return any(v.group == group for v in self._vars.values())

    def __len__(self):
        return len(self._vars)


class Node:
    def evaluate(self) -> Number:
        raise NotImplementedError

    def infix(self) -> str:
        raise NotImplementedError

    def postfix(self) -> str:
        raise NotImplementedError

    def prefix(self) -> str:
        raise NotImplementedError


class NodeConstant(Node):
    def __init__(self, value: Number):
        self.value = value

    def evaluate(self):
        return self.value

    def infix(self):
        return repr(self.value)

    postfix = infix
    prefix = infix


class NodeVariable(Node):
    def __init__(self, var: Variable):
        self.var = var

    def evaluate(self):
        return self.var.value

    def infix(self):
        return self.var.fullname

    postfix = infix
    prefix = infix


class NodeOperation2(Node):
    """Binary + - * /; int/int stays int with C-truncating division
    (Expression.h Value::operator/)."""

    def __init__(self, op: str, left: Node, right: Node):
        self.op = op
        self.left = left
        self.right = right

    def evaluate(self):
        a = self.left.evaluate()
        b = self.right.evaluate()
        if self.op == "+":
            return a + b
        if self.op == "-":
            return a - b
        if self.op == "*":
            return a * b
        if self.op == "/":
            if isinstance(a, int) and isinstance(b, int):
                q = abs(a) // abs(b)  # C++ int division truncates to 0
                return q if (a >= 0) == (b >= 0) else -q
            return a / b
        raise ValueError(f"unknown operator {self.op!r}")

    def infix(self):
        return f"({self.left.infix()} {self.op} {self.right.infix()})"

    def postfix(self):
        return f"{self.left.postfix()} {self.right.postfix()} {self.op}"

    def prefix(self):
        return f"{self.op} {self.left.prefix()} {self.right.prefix()}"


class NodeFunction(Node):
    def __init__(self, name: str, arg1: Node, arg2: Optional[Node] = None):
        self.name = name
        self.arg1 = arg1
        self.arg2 = arg2

    def evaluate(self):
        key = self.name.lower()
        if self.arg2 is None:
            return _FUNCS_1[key](self.arg1.evaluate())
        return _FUNCS_2[key](self.arg1.evaluate(), self.arg2.evaluate())

    def infix(self):
        if self.arg2 is None:
            return f"{self.name}({self.arg1.infix()})"
        return f"{self.name}({self.arg1.infix()}, {self.arg2.infix()})"

    def postfix(self):
        if self.arg2 is None:
            return f"{self.arg1.postfix()} {self.name}"
        return (f"{self.arg1.postfix()} {self.arg2.postfix()} "
                f"{self.name}")

    def prefix(self):
        if self.arg2 is None:
            return f"{self.name} {self.arg1.prefix()}"
        return f"{self.name} {self.arg1.prefix()} {self.arg2.prefix()}"


class NodeFunctionVarSet(Node):
    """sto/rcl: store a subexpression value into a variable / recall
    one (Expression.h NodeFunctionVarSet, functypeSTO/RCL)."""

    def __init__(self, name: str, varset: VariableSet, arg1: Node,
                 arg2: Optional[Node] = None):
        self.name = name.lower()
        self.varset = varset
        self.arg1 = arg1
        self.arg2 = arg2

    def evaluate(self):
        # the slot NAME is the string form of the top-of-stack node
        # (arg1), namespaced under "_localstore:"
        # (Expression.cpp:538-559)
        slot = f"_localstore:{self.arg1.infix()}"
        if self.name == "sto":
            val = self.arg2.evaluate()
            self.varset.set_variable(slot, val)
            return val
        if self.name == "rcl":
            var = self.varset.get_variable(slot)
            return var.value if var is not None else 0
        raise ValueError(self.name)

    def infix(self):
        if self.arg2 is None:
            return f"{self.name}({self.arg1.infix()})"
        return f"{self.name}({self.arg2.infix()}, {self.arg1.infix()})"

    def postfix(self):
        if self.arg2 is None:
            return f"{self.arg1.postfix()} {self.name}"
        return (f"{self.arg2.postfix()} {self.arg1.postfix()} "
                f"{self.name}")

    prefix = infix


_CONST_CHARS = set("0123456789.-E")


class Expression:
    """One parsed RPN expression (Expression.cpp initializeRPN)."""

    def __init__(self, exprstr: str = "",
                 varset: Optional[VariableSet] = None,
                 label: Optional[str] = None):
        self.varset = varset if varset is not None else VariableSet()
        self.root: Optional[Node] = None
        self.label = label or ""
        if exprstr:
            self.initialize_rpn(exprstr, genlabel=label is None)

    def initialize_rpn(self, exprstr: str, genlabel: bool = True):
        stack: List[Node] = []
        for token in exprstr.split():
            if len(token) == 1 and token in "+-*/":
                if len(stack) >= 2:
                    right = stack.pop()
                    left = stack.pop()
                    stack.append(NodeOperation2(token, left, right))
            elif set(token) <= _CONST_CHARS:
                if set(token) <= set("0123456789-"):
                    stack.append(NodeConstant(int(token)))
                else:
                    stack.append(NodeConstant(float(token)))
            elif ":" in token:
                stack.append(
                    NodeVariable(self.varset.add_variable(token))
                )
            else:
                key = token.lower()
                if key == "sto" and len(stack) >= 2:
                    a1 = stack.pop()
                    a2 = stack.pop()
                    stack.append(
                        NodeFunctionVarSet("sto", self.varset, a1, a2)
                    )
                elif key == "rcl" and stack:
                    stack.append(
                        NodeFunctionVarSet("rcl", self.varset,
                                           stack.pop())
                    )
                elif key in _FUNCS_2 and len(stack) >= 2:
                    a2 = stack.pop()
                    a1 = stack.pop()
                    stack.append(NodeFunction(key, a1, a2))
                elif key in _FUNCS_1 and stack:
                    stack.append(NodeFunction(key, stack.pop()))
                else:
                    raise ValueError(
                        f"expression token {token!r} is not an "
                        "operator/constant/variable/function"
                    )
        self.root = stack[-1] if stack else None
        if genlabel:
            self.label = self.infix()

    def evaluate(self) -> Number:
        if self.root is None:
            return 0
        return self.root.evaluate()

    def evaluate_float(self) -> float:
        return float(self.evaluate())

    def evaluate_int(self) -> int:
        return int(self.evaluate())

    def infix(self) -> str:
        return self.root.infix() if self.root is not None else ""

    def postfix(self) -> str:
        return self.root.postfix() if self.root is not None else ""

    def prefix(self) -> str:
        return self.root.prefix() if self.root is not None else ""
