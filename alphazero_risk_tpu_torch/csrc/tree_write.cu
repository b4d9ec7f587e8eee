// K6: the tree-node write of the batched MCTS.
//
// Replaces: alphazero_risk_tpu/mcts/search.py, the expansion writes and the
// leaf select of `simulate_once` (some twenty-five masked `.at[].set`
// scatters over the 14 GameState fields and 8 tree arrays of the new node,
// the child link, `next_free`, and the `where` that picks the leaf value
// and player), and the root writes of `init_tree`.
//
// Per game, when it is expanding (exp_n >= 0 and its root is not terminal):
// node idx = min(next_free, N - 1) receives the child state, expanded,
// terminal, value, player, parent, legal and prior;
// children[exp_n, exp_a, exp_o] = idx; next_free += 1.  A game that is not
// expanding writes nothing.  Every game emits its leaf value and player: the
// new node's when expanding, else those of the node the descent ended on.
// With root_mode the same copies go to node 0 for every game, with no
// parent, link, counter or leaf output.
//
// Bound on an H100: latency.  A game's node is about 1 KB, so the whole
// write at B=64 moves under 150 KB, far below a microsecond of memory time.
//
// Design: one 128-thread block per game; each field is a strided copy of a
// few words or bytes.  Pure copies, so the result equals the plain version
// bit for bit, bool fields (one byte each) included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLands = 42;
constexpr int kActions = 43;

struct StatePtrs {
  int32_t* owner;           // [.., 42]
  int32_t* army;            // [.., 42]
  int32_t* phase;
  int32_t* round;
  int32_t* cur_player;
  int32_t* reinforcements;
  int32_t* cards;           // [.., 2]
  int32_t* card_sets_played;
  int32_t* mob_from;
  int32_t* mob_to;
  uint8_t* can_draw_card;
  int32_t* attacks_during_turn;
  uint8_t* player_cards;    // [.., 2, 42]
  uint8_t* drawn_cards;     // [.., 42]
};

template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int64_t d,
                                         int64_t s, int width) {
  for (int i = threadIdx.x; i < width; i += kThreads)
    dst[d * width + i] = src[s * width + i];
}

__global__ void __launch_bounds__(kThreads)
write_nodes_kernel(StatePtrs ts, uint8_t* expanded, uint8_t* terminal,
                   float* value, int32_t* player, int32_t* parent,
                   uint8_t* legal, float* prior, int32_t* children,
                   int32_t* next_free, const int32_t* root, StatePtrs cs,
                   const uint8_t* term, const float* node_value,
                   const uint8_t* legal_c, const float* probs_c,
                   const int32_t* exp_n, const int32_t* exp_a,
                   const int32_t* exp_o, const int32_t* cur, float* leaf_v,
                   int32_t* leaf_p, int N, int root_mode) {
  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * N;

  int idx = 0;
  bool expanding = true;
  int en = 0;
  if (!root_mode) {
    en = exp_n[b];
    const bool root_done = terminal[base + root[b]] != 0;
    expanding = (en >= 0) && !root_done;
    en = en < 0 ? 0 : en;
    idx = expanding ? next_free[b] : 0;
    idx = idx < N - 1 ? idx : N - 1;
    if (threadIdx.x == 0) {
      const int64_t c = base + cur[b];
      leaf_v[b] = expanding ? node_value[b] : value[c];
      leaf_p[b] = expanding ? cs.cur_player[b] : player[c];
    }
    // every thread has read terminal[root], value[cur] and player[cur]
    // before any thread of this game overwrites node idx
    __syncthreads();
    if (!expanding) return;
  }

  const int64_t d = base + idx;
  copy_row(ts.owner, cs.owner, d, b, kLands);
  copy_row(ts.army, cs.army, d, b, kLands);
  copy_row(ts.cards, cs.cards, d, b, 2);
  copy_row(ts.player_cards, cs.player_cards, d, b, 2 * kLands);
  copy_row(ts.drawn_cards, cs.drawn_cards, d, b, kLands);
  copy_row(legal, legal_c, d, b, kActions);
  copy_row(prior, probs_c, d, b, kActions);
  if (threadIdx.x == 0) {
    ts.phase[d] = cs.phase[b];
    ts.round[d] = cs.round[b];
    ts.cur_player[d] = cs.cur_player[b];
    ts.reinforcements[d] = cs.reinforcements[b];
    ts.card_sets_played[d] = cs.card_sets_played[b];
    ts.mob_from[d] = cs.mob_from[b];
    ts.mob_to[d] = cs.mob_to[b];
    ts.can_draw_card[d] = cs.can_draw_card[b];
    ts.attacks_during_turn[d] = cs.attacks_during_turn[b];
    expanded[d] = 1;
    terminal[d] = term[b];
    value[d] = node_value[b];
    player[d] = cs.cur_player[b];
    if (!root_mode) {
      parent[d] = en;
      children[((base + en) * kActions + exp_a[b]) * 3 + exp_o[b]] = idx;
      next_free[b] += 1;
    }
  }
}

}  // namespace

// ts: the 14 GameState fields of the tree, [B, N, ...]; then the tree arrays
// expanded, terminal [B, N] bool, value f32, player, parent i32 [B, N],
// legal bool and prior f32 [B, N, 43], children i32 [B, N, 43, 3],
// next_free and root i32 [B].  cs: the 14 fields of the source states,
// [B, ...]; term bool, node_value f32 [B]; legal_c bool, probs_c f32
// [B, 43].  exp_n, exp_a, exp_o, cur i32 [B] and the outputs leaf_v f32,
// leaf_p i32 [B] may be null with root_mode.  State fields come in the order
// of the dataclass: owner, army, phase, round, cur_player, reinforcements,
// cards, card_sets_played, mob_from, mob_to, can_draw_card,
// attacks_during_turn, player_cards, drawn_cards.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int az_write_nodes(
    void* t0, void* t1, void* t2, void* t3, void* t4, void* t5, void* t6,
    void* t7, void* t8, void* t9, void* t10, void* t11, void* t12, void* t13,
    void* expanded, void* terminal, void* value, void* player, void* parent,
    void* legal, void* prior, void* children, void* next_free,
    const void* root, void* c0, void* c1, void* c2, void* c3, void* c4,
    void* c5, void* c6, void* c7, void* c8, void* c9, void* c10, void* c11,
    void* c12, void* c13, const void* term, const void* node_value,
    const void* legal_c, const void* probs_c, const void* exp_n,
    const void* exp_a, const void* exp_o, const void* cur, void* leaf_v,
    void* leaf_p, int B, int N, int root_mode, void* stream) {
  auto i32 = [](void* p) { return static_cast<int32_t*>(p); };
  auto u8 = [](void* p) { return static_cast<uint8_t*>(p); };
  auto ci32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const StatePtrs ts{i32(t0), i32(t1), i32(t2),  i32(t3),  i32(t4),
                     i32(t5), i32(t6), i32(t7),  i32(t8),  i32(t9),
                     u8(t10), i32(t11), u8(t12), u8(t13)};
  const StatePtrs cs{i32(c0), i32(c1), i32(c2),  i32(c3),  i32(c4),
                     i32(c5), i32(c6), i32(c7),  i32(c8),  i32(c9),
                     u8(c10), i32(c11), u8(c12), u8(c13)};
  write_nodes_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ts, u8(expanded), u8(terminal), static_cast<float*>(value), i32(player),
      i32(parent), u8(legal), static_cast<float*>(prior), i32(children),
      i32(next_free), ci32(root), cs, static_cast<const uint8_t*>(term),
      static_cast<const float*>(node_value),
      static_cast<const uint8_t*>(legal_c),
      static_cast<const float*>(probs_c), ci32(exp_n), ci32(exp_a),
      ci32(exp_o), ci32(cur), static_cast<float*>(leaf_v), i32(leaf_p), N,
      root_mode);
  return static_cast<int>(cudaGetLastError());
}
