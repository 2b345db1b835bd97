// The sLSTM's gating for one unit and one step, shared by the time loop's
// forward (slstm_scan.cu) and its backward (slstm_scan_backward.cu), so
// that the backward rebuilds the stabiliser and the gates with the very
// operations the forward ran: its test of a tie in max(log_f + m, pre_i)
// then sees the forward's values.  The exponentials are expf, log1pf and
// tanhf, not the fast intrinsics.
#pragma once

#include <math.h>

struct SlstmGates {
  float log_f;   // log_sigmoid(pre_f)
  float m_new;   // max(log_f + m, pre_i)
  float ig, fg;  // exp(pre_i - m_new), exp(log_f + m - m_new)
  float z, o;    // tanh(pre_z), sigmoid(pre_o)
};

// pre: the preactivations of the gates i, f, z, o; m: the stabiliser
// before the step
__device__ __forceinline__ SlstmGates slstm_gates(const float pre[4],
                                                  float m) {
  SlstmGates g;
  g.log_f = fminf(pre[1], 0.f) - log1pf(expf(-fabsf(pre[1])));
  g.m_new = fmaxf(g.log_f + m, pre[0]);
  g.ig = expf(pre[0] - g.m_new);
  g.fg = expf(g.log_f + m - g.m_new);
  g.z = tanhf(pre[2]);
  g.o = 1.f / (1.f + expf(-pre[3]));
  return g;
}
