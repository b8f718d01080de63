"""The parameter system — the port of the repository's
``examples/parameter_demo.py`` (the reference's example/parameter.cc).

    python -m dmlc_tpu_torch.examples.parameter_demo size=7 name=gemfield nhidden=32

Declares a parameter struct, initialises it from ``key=value`` arguments
(an alias among them; unknown keys are kept apart), and prints its
generated docstring, the parsed values, the unknown keys and the JSON:
the JAX example's output, character for character.
"""

import sys

from dmlc_tpu_torch import Parameter
from dmlc_tpu_torch.utils.params import field


class MyParam(Parameter):
    size = field(int, default=100, lower_bound=0, help="Dataset size.")
    name = field(str, default="hello", help="A name.")
    ratio = field(float, default=0.5, lower_bound=0.0, upper_bound=1.0,
                  help="A bounded ratio.")
    # an alias, like DMLC_DECLARE_ALIAS (example/parameter.cc:30)
    num_hidden = field(int, default=0, aliases=["nhidden"], help="Hidden units.")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    kwargs = dict(arg.split("=", 1) for arg in argv if "=" in arg)
    param = MyParam()
    unknown = param.init(kwargs, allow_unknown=True)
    print(MyParam.doc())
    print("\nparsed :", param.to_dict())
    print("unknown:", unknown)
    print("json   :", param.save_json())


if __name__ == "__main__":
    main()
