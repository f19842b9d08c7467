"""Multi-level sequence result adapter (counterpart of the JAX
``adapters/mlseq.py``).

Model output is a list of per-level lists ordered coarse-to-fine, each
level a sequence of per-iteration flows; entries may be (prev, flow)
tuples when the model emits previous-flow intermediates.
"""

from ...model import ModelAdapter, Result


class MultiLevelSequenceAdapter(ModelAdapter):
    def wrap_result(self, result, original_shape) -> Result:
        return MultiLevelSequenceResult(result, original_shape)


class MultiLevelSequenceResult(Result):
    def __init__(self, output, shape):
        super().__init__()
        self.result = output  # list of lists: (level, iteration)
        self.shape = shape

    def output(self, batch_index=None):
        if batch_index is None:
            return self.result

        def sl(x):
            return x[batch_index: batch_index + 1]

        if not isinstance(self.result[0][0], (tuple, list)):
            return [[sl(x) for x in level] for level in self.result]
        return [[[sl(x) for x in tp] for tp in level] for level in self.result]

    def final(self):
        final = self.result[-1][-1]
        return final[-1] if isinstance(final, (list, tuple)) else final

    def intermediate_flow(self):
        return self.result
